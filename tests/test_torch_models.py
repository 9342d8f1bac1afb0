"""The port's LM zoo (``repro_torch.models``) against the JAX package's, on
the CPU at ``.reduced()`` sizes, with the reference's weights carried across
(``params_from_reference``).

Tolerance in f32 (``dtype="float32"``, f32 caches): logits and every cache
tensor within ``atol = rtol = 1e-4`` (measured: ≤ 8e-7 on every arch).  The
bf16 runs, the MoE dispatch, the SSD scan and the reference's ragged-wave
behaviour are in ``test_torch_models_bf16.py`` (which imports this file's
helpers), the model-level properties and parameter counts in
``test_torch_model_props.py``, so that each file runs in under a minute on
one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import get_config as ref_config

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import decode_step, prefill
from repro_torch.models.convert import params_from_reference

F32_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, CACHE_LEN, Q_CHUNK = 3, 13, 32, 4
LENS = np.array([13, 7, 10], np.int64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' products are tiny: one intra-op thread runs them
    fastest and does not contend with the other test workers' threads.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_weights():
    """One reference init per arch (``PRNGKey(0)``) as numpy trees; the
    tree does not depend on the compute dtype."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rc = ref_config(arch).reduced()
            params = R.init_params(rc, jax.random.PRNGKey(0))
            cache[arch] = jax.tree.map(np.asarray, params)
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's jitted prefill and decode step per (arch, dtype),
    compiled once per module."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            rc, _ = _configs(arch, dtype)
            cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
            cache[arch, dtype] = (
                jax.jit(lambda p, b, li: R.prefill(
                    rc, p, b, CACHE_LEN, q_chunk=Q_CHUNK, cache_dtype=cdt,
                    last_index=li)),
                jax.jit(lambda p, t, c, pos: R.decode_step(rc, p, t, c, pos)),
            )
        return cache[arch, dtype]

    return get


def _configs(arch, dtype):
    rc = dataclasses.replace(ref_config(arch).reduced(), dtype=dtype)
    pc = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return rc, pc


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, size=(4, B, 1))
    return batch, steps


def _np(x):
    """f32 numpy of a reference array or a port tensor (detached: the
    port's parameters take gradients)."""
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, dtype=np.float32)


def _assert_caches_close(ref, port, where, **tol):
    """Every tensor of the reference's stacked caches against the port's
    list of per-unit dicts."""
    def walk(r, p, path):
        if isinstance(r, dict):
            assert set(r) == set(p), (path, set(r), set(p))
            for k in r:
                walk(r[k], p[k], path + (k,))
        else:
            np.testing.assert_allclose(_np(p), _np(r), err_msg=str(path),
                                       **tol)

    for u, unit in enumerate(port):
        walk(jax.tree.map(lambda x: x[u], ref), unit, (where, u))


def _reference_run(fns, tree, batch, steps, last_index, positions):
    """Reference prefill + four decode steps: the logits after each call and
    the caches after the last one."""
    pre, step = fns
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
              for k, v in batch.items()}
    caches, logits = pre(tree, jbatch, jnp.asarray(last_index, jnp.int32))
    out = [logits]
    for t, pos in zip(steps, positions):
        logits, caches = step(tree, jnp.asarray(t, jnp.int32), caches,
                              jnp.asarray(pos, jnp.int32))
        out.append(logits)
    return out, caches


def _port_run(pc, model, batch, steps, last_index, positions, cache_dtype):
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    caches, logits = prefill(pc, model, tbatch, CACHE_LEN, q_chunk=Q_CHUNK,
                             cache_dtype=cache_dtype,
                             last_index=torch.as_tensor(last_index))
    out = [logits]
    for t, pos in zip(steps, positions):
        logits, caches = decode_step(pc, model, torch.as_tensor(t), caches,
                                     torch.as_tensor(pos))
        out.append(logits)
    return out, caches


def _positions(cfg, vector):
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    if vector:  # per-sequence: each stream from its own true length
        return [prefix + LENS + i for i in range(4)]
    return [np.int64(prefix + S + i) for i in range(4)]


@pytest.mark.parametrize("vector_pos", [True, False], ids=["vector", "scalar"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_match_reference_f32(arch, vector_pos, ref_weights,
                                            ref_steps):
    """Ragged prefill (``last_index``) and four decode steps: logits and
    caches equal the reference's in f32."""
    _, pc = _configs(arch, "float32")
    tree = ref_weights(arch)
    model = params_from_reference(pc, tree)
    batch, steps = _inputs(pc)
    prefix = pc.n_patches if pc.family == "vlm" else 0
    last_index = prefix + LENS - 1
    positions = _positions(pc, vector_pos)
    ref_logits, ref_caches = _reference_run(
        ref_steps(arch, "float32"), tree, batch, steps, last_index, positions)
    logits, caches = _port_run(pc, model, batch, steps, last_index, positions,
                               torch.float32)
    for i, (r, p) in enumerate(zip(ref_logits, logits)):
        assert p.dtype == torch.float32 and p.shape == (B, pc.vocab_size)
        np.testing.assert_allclose(_np(p), _np(r), err_msg=f"call {i}",
                                   **F32_TOL)
    _assert_caches_close(ref_caches, caches, arch, **F32_TOL)
