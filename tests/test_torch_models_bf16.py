"""The port's LM zoo against the JAX package's, second half: every arch in
the configs' default bf16, the MoE dispatch with drops, the SSD scan at
ragged lengths, and the reference's behaviour on ragged waves (pinned, not
fixed).  CPU, ``.reduced()`` sizes, the reference's weights carried across.

Tolerances:
- bf16 (bf16 compute and caches): logits within ``atol = 5e-2``, ``rtol =
  0`` (measured: ≤ 0.029, on jamba; there the reference's own bf16 logits
  sit 0.021 from its f32 ones, the port's 0.017: the two packages round
  differently, by about as much as bf16 rounds at all);
- f32: ``atol = rtol = 1e-4`` (``F32_TOL``), the MoE outputs ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.models.mamba import ssd_chunked as ref_ssd_chunked
from repro.models.moe import _moe_dense_dispatch as ref_moe_dispatch

from repro_torch.configs import ARCHS
from repro_torch.models import prefill
from repro_torch.models.convert import params_from_reference
from repro_torch.models.mamba import ssd_chunked
from repro_torch.models.moe import _moe_dense_dispatch, moe_capacity

from test_torch_models import (  # noqa: F401  (fixtures)
    CACHE_LEN,
    F32_TOL,
    LENS,
    Q_CHUNK,
    _assert_caches_close,
    _configs,
    _inputs,
    _np,
    _port_run,
    _positions,
    _reference_run,
    one_torch_thread,
    ref_steps,
    ref_weights,
)

BF16_ATOL = 5e-2


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_match_reference_bf16(arch, ref_weights, ref_steps):
    """The configs' default bf16 compute and caches: logits within the
    measured bf16 tolerance of the reference's, vector positions."""
    _, pc = _configs(arch, "bfloat16")
    tree = ref_weights(arch)
    model = params_from_reference(pc, tree)
    batch, steps = _inputs(pc, seed=1)
    prefix = pc.n_patches if pc.family == "vlm" else 0
    last_index = prefix + LENS - 1
    positions = _positions(pc, True)
    ref_logits, _ = _reference_run(
        ref_steps(arch, "bfloat16"), tree, batch, steps, last_index, positions)
    logits, caches = _port_run(pc, model, batch, steps, last_index, positions,
                               torch.bfloat16)
    for i, (r, p) in enumerate(zip(ref_logits, logits)):
        assert p.dtype == torch.float32
        assert torch.isfinite(p).all()
        np.testing.assert_allclose(_np(p), _np(r), atol=BF16_ATOL, rtol=0,
                                   err_msg=f"call {i}")


# ---------------------------------------------------------------------------
# Modules with their own traps
# ---------------------------------------------------------------------------


def test_moe_dispatch_with_drops_matches_reference(ref_weights):
    """Sort-based capacity dispatch with overflowing experts: the same
    tokens drop, the same outputs and aux loss."""
    arch = "mixtral-8x7b"
    rc, pc = _configs(arch, "float32")
    tree = ref_weights(arch)
    model = params_from_reference(pc, tree)
    moe = model.units[0]["e0"].moe
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, pc.d_model)).astype(np.float32)
    # every token leans to expert 0, whose slab overflows
    r0 = tree["units"]["e0"]["moe"]["router"][0][:, 0]
    x += (2.0 * r0 / np.dot(r0, r0)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         tree["units"]["e0"]["moe"])
    ref_out, ref_aux = ref_moe_dispatch(rc, ref_p, jnp.asarray(x))
    out, aux = _moe_dense_dispatch(pc, moe, torch.as_tensor(x))
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    # the router sends more assignments to expert 0 than it has slots
    probs = torch.softmax(torch.as_tensor(x).reshape(-1, pc.d_model)
                          @ moe.router, dim=-1)
    top = torch.topk(probs, pc.top_k, dim=-1).indices
    cap = moe_capacity(pc, x.shape[0] * x.shape[1])
    assert cap == int(max(1, -(-32 * pc.top_k // pc.n_experts)
                          * pc.capacity_factor))
    assert int((top == 0).sum()) > cap


@pytest.mark.parametrize("L,chunk", [(13, 4), (16, 4), (7, 8)])
def test_ssd_chunked_matches_reference_and_padding_keeps_state(L, chunk):
    """``ssd_chunked`` at ``L % chunk != 0``: the padding changes the
    chunking, not the outputs or the final state."""
    rng = np.random.default_rng(L)
    Bz, H, P, G, N = 2, 4, 8, 1, 16
    x = rng.normal(size=(Bz, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bz, L, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(Bz, L, G, N)).astype(np.float32)
    Cm = rng.normal(size=(Bz, L, G, N)).astype(np.float32)
    y, st = ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)), chunk)
    ry, rst = ref_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    np.testing.assert_allclose(_np(y), _np(ry), **F32_TOL)
    np.testing.assert_allclose(_np(st), _np(rst), **F32_TOL)
    y1, st1 = ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)), 1)
    np.testing.assert_allclose(_np(y), _np(y1), **F32_TOL)
    np.testing.assert_allclose(_np(st), _np(st1), **F32_TOL)


# ---------------------------------------------------------------------------
# Reference behaviour on ragged waves, pinned (not fixed)
# ---------------------------------------------------------------------------


def _rel_diff(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _ragged_and_solo(arch, ref_weights):
    rc, pc = _configs(arch, "float32")
    tree = ref_weights(arch)
    model = params_from_reference(pc, tree)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, pc.vocab_size, size=(2, 12))
    lens = np.array([12, 5])
    toks[1, lens[1]:] = 0  # right padding, as ServeEngine pads
    ref_c, _ = R.prefill(rc, tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                         CACHE_LEN, q_chunk=Q_CHUNK, cache_dtype=jnp.float32,
                         last_index=jnp.asarray(lens - 1, jnp.int32))
    c, _ = prefill(pc, model, {"tokens": torch.as_tensor(toks)}, CACHE_LEN,
                   q_chunk=Q_CHUNK, cache_dtype=torch.float32,
                   last_index=torch.as_tensor(lens - 1))
    solo, _ = prefill(pc, model, {"tokens": torch.as_tensor(toks[1:, :5])},
                      CACHE_LEN, q_chunk=Q_CHUNK, cache_dtype=torch.float32)
    return ref_c, c, solo, pc


def test_ragged_wave_ssm_state_absorbs_padding(ref_weights):
    """As in the reference, the SSD state and conv tail of a short prompt in
    a right-padded wave run over the pad tokens: they equal the
    reference's, and differ from the same prompt prefilled alone."""
    ref_c, c, solo, _ = _ragged_and_solo("mamba2-370m", ref_weights)
    _assert_caches_close(ref_c, c, "mamba2", **F32_TOL)
    for key in ("state", "conv"):
        assert _rel_diff(c[0]["e0"][key][1], solo[0]["e0"][key][0]) > 0.1


def test_ragged_wave_ring_keeps_padded_tail(ref_weights):
    """As in the reference, a local layer's ring keeps the last ``cap``
    positions of the padded length: the short prompt's ring holds pad-token
    keys, equal to the reference's, and not its solo ring."""
    ref_c, c, solo, pc = _ragged_and_solo("starcoder2-3b", ref_weights)
    _assert_caches_close(ref_c, c, "starcoder2", **F32_TOL)
    ring, alone = c[0]["e0"]["k"][1], solo[0]["e0"]["k"][0]
    assert ring.shape[0] == alone.shape[0] == pc.window
    assert _rel_diff(ring, alone) > 0.1
