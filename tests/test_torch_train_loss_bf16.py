"""The port's training loss against the JAX package's, second half: every
family in the configs' default bf16, ``chunked_cross_entropy`` (padded,
softcapped, masked; its logits never saved for the backward), the gradient
of ``matmul_f32`` (the reference's on the host; the card's hand-written
one), gemma2's capped attention softmax (one saved f32 tensor, the values
and gradients of autograd's chain bit for bit) and trainable parameters
with a serving path that records no graph.
CPU, ``.reduced()`` sizes, the reference's weights carried across.

Tolerances in bf16: the loss within ``atol = 5e-2``; a gradient leaf
within ``atol = 5e-2 · max(1, max |reference leaf|)``, ``rtol = 0``, but
jamba's within ``1e-1 ·`` that scale.  At ``5e-2 ·`` this test failed on
jamba alone, on its mamba ``conv_b`` (0.053 of the leaf's scale between
the packages).  Measured against each package's own f32 gradients (same
weights and batch, same scale): the reference's bf16 ``conv_b`` is off by
up to 0.0631 of the scale, the port's by up to 0.0462 (the largest of
jamba's 14 ``conv_b`` leaves, ``units.0.e1``, in both) — the reference
itself is past ``5e-2`` there, so the looser bound measures bf16 rounding
of a sum of cotangents over every position, not a fault of the port.
``tests/test_torch_bf16_error.py`` holds the port's error to no more than
the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import chunked_cross_entropy as ref_cross_entropy

from repro_torch.models import common as C
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.common import chunked_cross_entropy, matmul_f32
from repro_torch.models.convert import named_from_tree, params_from_reference

from test_torch_models import one_torch_thread, ref_weights  # noqa: F401
from test_torch_train_loss import (
    B,
    _batch,
    _configs,
    port_loss_and_grads,
    reference_loss_and_grads,
)

BF16_ATOL = 5e-2
#: jamba's gradient tolerance (see the module's docstring)
HYBRID_GRAD_ATOL = 1e-1
FAMILIES = ["starcoder2-3b", "gemma2-9b", "mixtral-8x7b", "olmoe-1b-7b",
            "mamba2-370m", "jamba-v0.1-52b", "llava-next-34b", "whisper-tiny"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference_bf16(arch, ref_weights):
    """Each family (dense, softcapped, MoE, SSM, hybrid, VLM prefix,
    encoder-decoder) in bf16 compute with f32 parameters."""
    rc, pc = _configs(arch, "bfloat16")
    tree = ref_weights(arch)
    batch = _batch(pc, seed=1)
    ref_loss, ref_grads = reference_loss_and_grads(rc, tree, batch)
    loss, grads = port_loss_and_grads(pc, tree, batch)
    assert np.isfinite(loss) and abs(loss - ref_loss) <= BF16_ATOL
    want = named_from_tree(pc, ref_grads)
    for name, g in grads.items():
        r = want[name].astype(np.float32)
        scale = max(1.0, float(np.abs(r).max()))
        atol = (HYBRID_GRAD_ATOL if pc.family == "hybrid" else BF16_ATOL) * scale
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "s, chunk, cap, masked",
    [(21, 8, None, False), (21, 8, 30.0, True), (16, 16, None, False),
     (5, 16, 50.0, False)],
)
def test_chunked_cross_entropy_matches_reference(dtype, s, chunk, cap,
                                                 masked):
    """Padded last chunk, one chunk longer than S, final softcap and a
    label mask: the loss and the gradients of ``h`` and ``w_vocab``
    against ``jax.value_and_grad`` of the reference's."""
    rng = np.random.default_rng(s + chunk)
    v, d = 37, 12
    h = rng.normal(size=(B, s, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(v, d))).astype(np.float32)
    labels = rng.integers(0, v, (B, s))
    mask = (rng.random((B, s)) < 0.7) if masked else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def ref(hh, ww):
        return ref_cross_entropy(
            hh, ww, jnp.asarray(labels), chunk=chunk, final_softcap=cap,
            label_mask=None if mask is None else jnp.asarray(mask))

    ref_loss, (ref_dh, ref_dw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    tdt = getattr(torch, dtype)
    th = torch.tensor(h).to(tdt).requires_grad_()
    tw = torch.tensor(w).to(tdt).requires_grad_()
    loss = chunked_cross_entropy(
        th, tw, torch.as_tensor(labels), chunk=chunk, final_softcap=cap,
        label_mask=None if mask is None else torch.as_tensor(mask))
    loss.backward()
    assert loss.dtype == torch.float32
    assert th.grad.dtype == tw.grad.dtype == tdt
    if dtype == "float32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:  # one bf16 rounding of each gradient element
        tol = dict(atol=1e-3, rtol=2 ** -7)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(ref_dh, np.float32), **tol)
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               np.asarray(ref_dw, np.float32), **tol)


def test_chunked_cross_entropy_never_saves_the_logits():
    """Each chunk runs checkpointed: autograd holds no (B, chunk, V) logits
    for the backward, where the same loop without the checkpoint does."""
    rng = np.random.default_rng(0)
    v, d, s, chunk = 97, 8, 32, 8
    h = torch.tensor(rng.normal(size=(B, s, d)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(v, d)), dtype=torch.float32,
                     requires_grad=True)
    labels = torch.as_tensor(rng.integers(0, v, (B, s)))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = chunked_cross_entropy(h, w, labels, chunk=chunk)
    assert not [sh for sh in shapes if sh and sh[-1] == v and len(sh) == 3]
    loss.backward()
    shapes.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        C._chunk_nll(h[:, :chunk], w, labels[:, :chunk],
                     torch.ones(B, chunk), None)
    assert (B, chunk, v) in shapes  # the unchecked body would hold them


def _ref_matmul_grads(a, b, g):
    """jax.vjp of the reference's f32-output einsum of bf16 operands."""
    out, vjp = jax.vjp(
        lambda x, y: jnp.einsum("md,dn->mn", x, y,
                                preferred_element_type=jnp.float32),
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    da, db = vjp(jnp.asarray(g, jnp.float32))
    return np.asarray(out), da, db


def test_matmul_f32_gradient_on_the_host_is_the_reference():
    """bf16 operands on the host go through upcast operands: autograd's
    gradient is the reference's (the f32 cotangent times the other
    operand, rounded to bf16), within one bf16 rounding."""
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(7, 24)), rng.normal(size=(24, 5))
    g = rng.normal(size=(7, 5)).astype(np.float32)
    out, da, db = _ref_matmul_grads(a, b, g)
    ta = torch.tensor(a, dtype=torch.bfloat16, requires_grad=True)
    tb = torch.tensor(b, dtype=torch.bfloat16, requires_grad=True)
    y = matmul_f32(ta, tb)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), out, rtol=1e-6, atol=1e-6)
    y.backward(torch.tensor(g))
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
    assert da.dtype == db.dtype == jnp.bfloat16
    np.testing.assert_allclose(ta.grad.float().numpy(),
                               np.asarray(da, np.float32), rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(tb.grad.float().numpy(),
                               np.asarray(db, np.float32), rtol=2 ** -7,
                               atol=1e-6)


def test_matmul_f32_hand_written_gradient(monkeypatch):
    """The card's gradient (``_MatmulF32``), run on the host with its
    bf16-in / f32-out GEMM standing in as an f32 GEMM of the same values:
    bf16 gradients equal to (bf16(g) · other operand) rounded to bf16 —
    the deliberate difference from the reference, which multiplies the
    f32 cotangent — and within two bf16 roundings of ``jax.vjp``'s."""
    monkeypatch.setattr(C, "_mm_f32", lambda x, y: x.float() @ y.float())
    rng = np.random.default_rng(2)
    for shape_a, shape_b in (((7, 24), (24, 5)), ((3, 7, 24), (3, 24, 5))):
        a, b = rng.normal(size=shape_a), rng.normal(size=shape_b)
        g = rng.normal(size=shape_a[:-1] + shape_b[-1:]).astype(np.float32)
        ta = torch.tensor(a, dtype=torch.bfloat16, requires_grad=True)
        tb = torch.tensor(b, dtype=torch.bfloat16, requires_grad=True)
        y = C._MatmulF32.apply(ta, tb)
        assert y.dtype == torch.float32
        y.backward(torch.tensor(g))
        gb = torch.tensor(g).to(torch.bfloat16).float()
        want_a = (gb @ tb.detach().float().transpose(-1, -2)).to(torch.bfloat16)
        want_b = (ta.detach().float().transpose(-1, -2) @ gb).to(torch.bfloat16)
        assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
        assert torch.equal(ta.grad, want_a) and torch.equal(tb.grad, want_b)
        if len(shape_a) == 2:
            _, da, db = _ref_matmul_grads(a, b, g)
            np.testing.assert_allclose(ta.grad.float().numpy(),
                                       np.asarray(da, np.float32),
                                       rtol=2 ** -6, atol=1e-2)
            np.testing.assert_allclose(tb.grad.float().numpy(),
                                       np.asarray(db, np.float32),
                                       rtol=2 ** -6, atol=1e-2)


def _capped_attention_by_autograd(q, k, v, mask, scale, cap):
    """A q chunk's attention with gemma2's softcap as autograd's chain of
    operators, each saving what it saves."""
    from repro_torch.models import attention as A

    scores = C.softcap(A._scores(q, k) * scale, cap)
    if mask is not None:
        scores = scores.masked_fill(~mask, A.NEG_INF)
    return A._probs_v(torch.softmax(scores, dim=-1).to(v.dtype), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [True, False])
def test_capped_softmax_equals_autograd_chain(dtype, masked):
    """``attention._attend_chunk`` with a softcap (``_CappedSoftmax``)
    gives the values and the q / k / v gradients of autograd's chain bit
    for bit, a fully hidden row included, and saves one f32 tensor of the
    scores' shape (``tanh(s / cap)``) where the chain saves two (``tanh``'s
    and ``softmax``'s outputs)."""
    from repro_torch.models import attention as A

    g = torch.Generator().manual_seed(3)
    B_, qc, KV, G, hd, Sk = 2, 8, 2, 3, 16, 12

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    q = draw(B_, qc, KV, G, hd, scale=3.0).requires_grad_()
    k = draw(B_, Sk, KV, hd, scale=3.0).requires_grad_()
    v = draw(B_, Sk, KV, hd).requires_grad_()
    grad = draw(B_, qc, KV, G, hd)
    mask = None
    if masked:
        mask = torch.arange(qc)[:, None] + 4 >= torch.arange(Sk)[None, :]
        mask[0] = False
    got, want = [], []
    saved = {}
    for fn, into in ((A._attend_chunk, got),
                     (_capped_attention_by_autograd, want)):
        sizes = []

        def pack(t, sizes=sizes):
            sizes.append((t.dtype, tuple(t.shape)))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(q, k, v, mask, 0.25, 5.0)
        into.extend([out, *torch.autograd.grad(out, (q, k, v), grad)])
        saved[fn] = [s for s in sizes if s == (torch.float32,
                                               (B_, KV, G, qc, Sk))]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(saved[A._attend_chunk]) == 1
    assert len(saved[_capped_attention_by_autograd]) == 2


def test_parameters_train_and_serving_records_no_graph(ref_weights):
    """Every parameter takes a gradient; prefill and decode run in
    inference mode, so their outputs carry no graph."""
    _, pc = _configs("starcoder2-3b", "float32")
    model = params_from_reference(pc, ref_weights("starcoder2-3b"))
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (1, 6)))
    caches, logits = prefill(pc, model, {"tokens": tokens}, 16, q_chunk=4)
    step, caches = decode_step(pc, model, tokens[:, :1], caches, 6)
    for t in (logits, step, caches[0]["e0"]["k"]):
        assert not t.requires_grad and t.grad_fn is None
    assert not init_caches(pc, 1, 8)[0]["e0"]["k"].requires_grad
