"""The port's training loss and its gradients (``repro_torch.models.
train_loss``) against ``jax.value_and_grad`` of the JAX package's, on the
CPU at ``.reduced()`` sizes in f32 (``dtype="float32"``), the reference's
weights carried across (``params_from_reference``).

Tolerances: the loss within ``rtol = 1e-5``; every gradient leaf within
``atol = rtol = 1e-4``.  ``S = 21`` pads the last loss chunk
(``loss_chunk`` 16) and the last q chunk (8).  Also here: the remat
modes.  The bf16 runs, ``chunked_cross_entropy`` and the gradient of
``matmul_f32`` are in ``test_torch_train_loss_bf16.py``, so that each file
runs in under a minute on one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models as R
from repro.configs import get_config as ref_config

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import train_loss
from repro_torch.models.convert import named_from_tree, params_from_reference

from test_torch_models import one_torch_thread, ref_weights  # noqa: F401

B, S, Q_CHUNK = 2, 21, 8
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(arch, dtype, **kw):
    rc = dataclasses.replace(ref_config(arch).reduced(), dtype=dtype, **kw)
    pc = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **kw)
    return rc, pc


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def reference_loss_and_grads(rc, tree, batch):
    """``jax.value_and_grad`` of the reference's ``train_loss``: the loss
    and the gradient tree as numpy."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: R.train_loss(rc, p, jb, q_chunk=Q_CHUNK)))(tree)
    return float(loss), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(pc, tree, batch):
    """The port's loss and ``{name: gradient}`` (every parameter must get
    one) for the reference's weights ``tree``."""
    model = params_from_reference(pc, tree)
    loss = train_loss(pc, model, {k: torch.as_tensor(v)
                                  for k, v in batch.items()},
                      q_chunk=Q_CHUNK)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        assert p.grad.dtype == p.dtype, name
        grads[name] = p.grad.float().numpy()
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_loss_and_grads_match_reference_f32(arch, ref_weights):
    rc, pc = _configs(arch, "float32")
    tree = ref_weights(arch)
    batch = _batch(pc)
    ref_loss, ref_grads = reference_loss_and_grads(rc, tree, batch)
    loss, grads = port_loss_and_grads(pc, tree, batch)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    want = named_from_tree(pc, ref_grads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("arch",
                         ["starcoder2-3b", "jamba-v0.1-52b", "whisper-tiny"])
def test_remat_modes_give_the_same_gradients(arch, ref_weights):
    """``remat`` none, full (per unit, inputs only) and dots (the products
    saved) recompute the same values: the same loss and gradients, bit for
    bit on the host."""
    tree = ref_weights(arch)
    batch = _batch(get_config(arch).reduced())
    out = {}
    for remat in ("none", "full", "dots"):
        _, pc = _configs(arch, "float32", remat=remat)
        out[remat] = port_loss_and_grads(pc, tree, batch)
    loss, grads = out["none"]
    for remat in ("full", "dots"):
        assert out[remat][0] == loss, remat
        for name, g in grads.items():
            np.testing.assert_array_equal(out[remat][1][name], g,
                                          err_msg=f"{remat} {name}")


class _CountOps(TorchDispatchMode):
    """Counts the ``aten.mm`` calls and the ``aten.rsqrt`` calls (one per
    RMS norm) that reach the kernels."""

    def __init__(self):
        super().__init__()
        self.mm = self.rsqrt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        self.rsqrt += func is torch.ops.aten.rsqrt.default
        return func(*args, **(kwargs or {}))


def test_remat_modes_recompute_what_they_do_not_save(ref_weights):
    """The backward of "none" recomputes nothing; of "full" each unit's
    forward, products and norms; of "dots" the unit's norms but not its
    products, whose outputs it saved."""
    tree = ref_weights("starcoder2-3b")
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(get_config("starcoder2-3b").reduced()).items()}
    mm, norms = {}, {}
    for remat in ("none", "dots", "full"):
        _, pc = _configs("starcoder2-3b", "float32", remat=remat)
        model = params_from_reference(pc, tree)
        loss = train_loss(pc, model, batch, q_chunk=Q_CHUNK)
        with _CountOps() as count:
            loss.backward()
        mm[remat], norms[remat] = count.mm, count.rsqrt
    assert mm["none"] == mm["dots"] < mm["full"], mm
    assert norms["none"] < norms["dots"] == norms["full"], norms
