"""The port's step builders (``repro_torch.launch.steps``) against the JAX
package's, on their 1 × 1 meshes, with the reference's reduced configs
(``tests/test_launch_steps.py``'s ``_cfg``) in f32 and the reference's
weights carried across (``params_from_reference``):

* one ``make_train_step`` step per arch of the reference's list, plus
  olmoe: the loss, the new parameters, μ and ν within atol = rtol = 1e-4 of
  the reference's jitted step (``cast_params_once`` rounds the matrices to
  bf16 in both);
* the prefill step (gemma2, mixtral, whisper) and the decode step (gemma2,
  mamba2, jamba): logits within ``tests/test_torch_models.py``'s f32
  tolerance (1e-4); the prefill step's caches, which both packages store
  in bf16 (the steps' default cache dtype), within one bf16 ulp (rtol
  2⁻⁷, atol 1e-4); the decode step updates the caller's caches in place;
* the port's step equals its own parts composed by hand — ``train_loss``
  per microbatch, their mean and ``adamw_update`` — bit for bit, as
  ``chip_smoke.py`` holds it on the card;
* on two gloo ranks (``tests/torch_lm_ranks.py``, a child process):
  ``_moe_sharded`` equals the reference's ``_moe_dense_dispatch`` of each
  half of the batch with ``aux`` averaged, within 1e-6; and one sharded
  train step on (2, 1) and (1, 2) meshes — state sharded by the rules,
  gathered, gradients reduce-scattered — equals the one-position step
  within 1e-5.

The pytest process builds no ``DeviceMesh`` and starts no process group:
the 1 × 1 meshes are the port's plain ``Mesh``."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.launch.steps import make_train_step as ref_train_step
from repro.models.moe import _moe_dense_dispatch as ref_dense_dispatch
from repro.train.optimizer import init_opt_state as ref_init_opt

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainHParams
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import (
    make_decode_step, make_prefill_step, make_train_step, train_microbatches,
)
from repro_torch.models import init_caches, init_params, train_loss
from repro_torch.models import decode_step, prefill
from repro_torch.models.convert import named_from_tree, params_from_reference
from repro_torch.models.moe import DistCtx, _moe_dense_dispatch, moe_apply
from repro_torch.train.optimizer import adamw_update, init_opt_state

from test_torch_models import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(atol=1e-4, rtol=1e-4)
#: one bf16 ulp: a cache value either package rounds to bf16 the other way
CACHE_TOL = dict(atol=1e-4, rtol=2.0**-7)

ARCHS = ["starcoder2-3b", "gemma2-9b", "mixtral-8x7b", "mamba2-370m",
         "jamba-v0.1-52b", "whisper-tiny", "llava-next-34b", "olmoe-1b-7b"]
B_TRAIN, B_SERVE, S = 4, 2, 32


def _cfg(get, arch):
    cfg = get(arch).reduced()
    # reduced shapes must divide the tiny seq len
    return dataclasses.replace(
        cfg, vocab_size=128, loss_chunk=16, q_chunk=16,
        microbatches=2 if cfg.n_experts else 1, ssm_chunk=8, dtype="float32",
    )


def _shapes(kind, batch):
    return (RefShape("s", seq_len=S, global_batch=batch, kind=kind),
            ShapeConfig("s", seq_len=S, global_batch=batch, kind=kind))


def _batch(cfg, batch, labels=True, seed=1):
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, s_text)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (batch, s_text)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def meshes():
    return ref_test_mesh((1, 1), ("data", "model")), make_test_mesh(
        (1, 1), device_type="cpu")


def _weights(arch):
    rc = _cfg(ref_config, arch)
    return jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(0)))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, meshes):
    ref_mesh, mesh = meshes
    rc, pc = _cfg(ref_config, arch), _cfg(get_config, arch)
    rs, ps = _shapes("train", B_TRAIN)
    tree = _weights(arch)
    batch = _batch(pc, B_TRAIN)

    fn, in_sh, out_sh, _, donate = ref_train_step(rc, rs, ref_mesh)
    jp = jax.tree.map(jnp.asarray, tree)
    new_p, new_o, loss, metrics = jax.jit(
        fn, in_shardings=in_sh, out_shardings=out_sh, donate_argnums=donate,
    )(jp, ref_init_opt(jp), {k: jnp.asarray(v) for k, v in batch.items()})

    pfn, _, _, _, pdonate = make_train_step(pc, ps, mesh)
    assert pdonate == donate == (0, 1)
    model = params_from_reference(pc, tree)
    got_p, got_o, got_loss, got_m = pfn(model, init_opt_state(model),
                                        _torch(batch))
    np.testing.assert_allclose(float(got_loss), float(loss), **TOL)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(metrics["grad_norm"]), **TOL)
    assert int(got_o.step) == int(new_o.step) == 1
    for tag, want, got in (
        ("params", named_from_tree(pc, jax.tree.map(np.asarray, new_p)),
         {n: p.detach().numpy() for n, p in got_p.named_parameters()}),
        ("mu", named_from_tree(pc, jax.tree.map(np.asarray, new_o.mu)),
         {n: t.numpy() for n, t in got_o.mu.items()}),
        ("nu", named_from_tree(pc, jax.tree.map(np.asarray, new_o.nu)),
         {n: t.numpy() for n, t in got_o.nu.items()}),
    ):
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], err_msg=f"{tag} {n}",
                                       **TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "starcoder2-3b"])
def test_train_step_equals_its_parts_bit_for_bit(arch, meshes):
    """``train_loss`` per microbatch on a copy of the model whose leaves
    ``cast_params_once`` casts are bf16 (their gradients bf16 too), the
    mean of the losses and of the gradients in f32, then ``adamw_update``
    on the f32 model: the step's own arithmetic, so equal bit for bit."""
    _, mesh = meshes
    pc = _cfg(get_config, arch)
    _, ps = _shapes("train", B_TRAIN)
    batch = _torch(_batch(pc, B_TRAIN))
    fn, _, _, _, _ = make_train_step(pc, ps, mesh)
    g = torch.Generator().manual_seed(0)
    model = init_params(pc, g, "cpu")
    hand = init_params(pc, torch.Generator().manual_seed(0), "cpu")
    p_out, o_out, loss, metrics = fn(model, init_opt_state(model), batch)

    k = train_microbatches(pc)
    for n, p in hand.named_parameters():  # cast_params_once
        if "moe" not in n.split(".") and (p.dim() >= 2 or n.startswith("units")):
            p.data = p.data.to(torch.bfloat16)
    losses, grads = [], []
    for i in range(k):
        mb = {key: v.reshape((k, -1) + v.shape[1:])[i] for key, v in batch.items()}
        hand.zero_grad(set_to_none=True)
        lv = train_loss(pc, hand, mb, q_chunk=pc.q_chunk, dist=DistCtx(mesh, ("data",)))
        lv.backward()
        losses.append(lv.detach())
        grads.append({n: p.grad.clone() for n, p in hand.named_parameters()})
    if k == 1:
        want_loss, want_grads = losses[0], grads[0]
    else:
        want_loss = sum(losses, torch.zeros(())) / k
        want_grads = {n: sum((gr[n].float() for gr in grads),
                             torch.zeros(())) / k for n in grads[0]}
    ref = init_params(pc, torch.Generator().manual_seed(0), "cpu")
    _, want_o, want_m = adamw_update(TrainHParams(), ref, want_grads,
                                     init_opt_state(ref))
    assert torch.equal(loss, want_loss)
    assert torch.equal(metrics["grad_norm"], want_m["grad_norm"])
    for (n, p), (_, q) in zip(p_out.named_parameters(), ref.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(o_out.mu[n], want_o.mu[n]), n
        assert torch.equal(o_out.nu[n], want_o.nu[n]), n


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x7b", "whisper-tiny"])
def test_prefill_step_matches_reference(arch, meshes):
    ref_mesh, mesh = meshes
    rc, pc = _cfg(ref_config, arch), _cfg(get_config, arch)
    rs, ps = _shapes("prefill", B_SERVE)
    tree = _weights(arch)
    batch = _batch(pc, B_SERVE, labels=False)
    fn, in_sh, out_sh, _, _ = ref_prefill_step(rc, rs, ref_mesh)
    caches, logits = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    pfn, _, (c_sh, l_sh), _, donate = make_prefill_step(pc, ps, mesh)
    assert donate == ()
    got_c, got_l = pfn(params_from_reference(pc, tree), _torch(batch))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(logits), **TOL)
    assert len(got_c) == len(c_sh) == pc.n_units
    for u, unit in enumerate(got_c):
        for e, entry in unit.items():
            flat = dict(entry)
            flat.update({f"self.{k}": v for k, v in flat.pop("self", {}).items()})
            for name, t in flat.items():
                want = caches[e]
                for part in name.split("."):
                    want = want[part]
                tol = CACHE_TOL if t.dtype == torch.bfloat16 else TOL
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(want[u], np.float32),
                    err_msg=f"unit {u} {e} {name}", **tol)


@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-370m", "jamba-v0.1-52b"])
def test_decode_step_matches_reference(arch, meshes):
    """The reference's test runs its decode step on zeroed caches at
    position 3; so does this one, after a prefill of both packages."""
    ref_mesh, mesh = meshes
    rc, pc = _cfg(ref_config, arch), _cfg(get_config, arch)
    rs, ps = _shapes("decode", B_SERVE)
    tree = _weights(arch)
    toks = np.random.default_rng(2).integers(0, pc.vocab_size, (B_SERVE, 1)).astype(np.int32)
    fn, in_sh, out_sh, _, donate = ref_decode_step(rc, rs, ref_mesh)
    step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                   donate_argnums=donate)
    jp = jax.tree.map(jnp.asarray, tree)
    logits, _ = step(jp, jnp.asarray(toks), RM.init_caches(rc, B_SERVE, S),
                     jnp.int32(3))
    pfn, _, _, _, pdonate = make_decode_step(pc, ps, mesh)
    assert pdonate == donate == (2,)
    caches = init_caches(pc, B_SERVE, S)
    got, out_caches = pfn(params_from_reference(pc, tree), torch.from_numpy(toks),
                          caches, 3)
    assert out_caches is caches  # donated: updated in place
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)


def test_moe_dist_on_one_position_is_the_dense_dispatch(meshes):
    """``DistCtx`` over a mesh with no process group (one position): the
    sharded dispatch is the dense one, bit for bit, and so are a prefill
    and a decode step against ``dist=None``."""
    _, mesh = meshes
    cfg = _cfg(get_config, "olmoe-1b-7b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    moe = model.units[0]["e0"].moe
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    dist = DistCtx(mesh, ("data",))
    o1, a1 = moe_apply(cfg, moe, x, dist)
    o0, a0 = _moe_dense_dispatch(cfg, moe, x)
    assert torch.equal(o1, o0) and torch.equal(a1, a0)
    batch = _torch(_batch(cfg, B_SERVE, labels=False))
    c0, l0 = prefill(cfg, model, batch, S)
    c1, l1 = prefill(cfg, model, batch, S, dist=dist)
    assert torch.equal(l0, l1)
    tok = torch.zeros((B_SERVE, 1), dtype=torch.int32)
    d0, _ = decode_step(cfg, model, tok, c0, S - 2)
    d1, _ = decode_step(cfg, model, tok, c1, S - 2, dist=dist)
    assert torch.equal(d0, d1)


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    run = subprocess.run([sys.executable, os.path.join(HERE, "torch_lm_ranks.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    return out


def test_moe_sharded_on_two_ranks_matches_reference(rank_outputs):
    import torch_lm_ranks as L

    cfg = L.moe_config()
    model = L.init_model(cfg).units[0]["e0"].moe
    x = L.moe_inputs(cfg)
    rc = dataclasses.replace(ref_config("olmoe-1b-7b").reduced(), dtype="float32")
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    half = x.shape[0] // L.WORLD
    auxes = []
    for r in range(L.WORLD):
        got = np.load(rank_outputs / f"moe{r}.npz")
        out, aux = ref_dense_dispatch(rc, params, jnp.asarray(x[r * half:(r + 1) * half]))
        np.testing.assert_allclose(got["out"], np.asarray(out), atol=1e-6, rtol=1e-6)
        auxes.append(float(aux))
    for r in range(L.WORLD):
        got = np.load(rank_outputs / f"moe{r}.npz")
        np.testing.assert_allclose(float(got["aux"]), np.mean(auxes), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("tag", ["2x1", "1x2"])
def test_sharded_train_step_on_two_ranks_equals_one_position(tag, rank_outputs,
                                                             meshes):
    import torch_lm_ranks as L

    _, mesh = meshes
    cfg = L.train_config()
    shape = ShapeConfig("t", seq_len=L.S, global_batch=L.B, kind="train")
    fn, _, _, _, _ = make_train_step(cfg, shape, mesh)
    model = L.init_model(cfg)
    p, o, loss, m = fn(model, init_opt_state(model), _torch(L.train_inputs(cfg)))
    got = np.load(rank_outputs / f"train_{tag}.npz")
    np.testing.assert_allclose(got["loss"], loss.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], m["grad_norm"].numpy(),
                               atol=1e-5, rtol=1e-5)
    for n, t in p.named_parameters():
        for key, want in (("p", t.detach()), ("mu", o.mu[n]), ("nu", o.nu[n])):
            np.testing.assert_allclose(got[f"{key}:{n}"], want.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{key} {n}")
