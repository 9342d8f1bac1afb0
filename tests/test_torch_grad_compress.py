"""The port's int8 gradient compression (``repro_torch.train.
grad_compress``) against the JAX package's: ``quantize`` / ``dequantize``
and ``ErrorFeedback`` bit for bit on seeded gradients, the reference's own
properties (``tests/test_grad_compress.py``: the half-step error bound,
error feedback recovering a signal below one quantum, convergence on a
quadratic), and ``compressed_psum`` over two gloo ranks, run in a child
process (``tests/torch_compress_ranks.py``: ``subprocess.run`` with a
timeout, a ``file://`` rendezvous under ``tmp_path``), equal on every rank
to the quantized mean computed with the reference's arithmetic.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train as RT

from repro_torch.train import (
    ErrorFeedback, compressed_psum, dequantize, quantize,
)

import torch_compress_ranks
from test_torch_models import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed, scale", [(0, 1.0), (1, 1e-6), (2, 1e6),
                                         (3, 3.7e-3)])
def test_quantize_equals_reference(seed, scale):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(129, 17)) * scale).astype(np.float32)
    q, s = quantize(torch.from_numpy(g))
    rq, rs = RT.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(dequantize(q, s).numpy(),
                                  np.asarray(RT.dequantize(rq, rs)))


def test_quantize_zeros_and_bf16():
    q, s = quantize(torch.zeros(5))
    assert float(s) == float(RT.quantize(jnp.zeros(5))[1]) and not q.any()
    g = np.random.default_rng(4).normal(size=64).astype(np.float32)
    q, s = quantize(torch.from_numpy(g).to(torch.bfloat16))
    rq, rs = RT.quantize(jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=(128, 64)), dtype=torch.float32)
    q, s = quantize(g)
    err = (dequantize(q, s) - g).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-7  # half-ULP of the grid


def test_error_feedback_equals_reference():
    rng = np.random.default_rng(7)
    shapes = {"a": (8, 3), "b": (5,)}
    ef = ErrorFeedback({k: torch.zeros(v) for k, v in shapes.items()})
    ref = RT.ErrorFeedback({k: jnp.zeros(v) for k, v in shapes.items()})
    for _ in range(25):
        grads = {k: (rng.normal(size=v) * rng.choice([1e-3, 1.0, 40.0])
                     ).astype(np.float32) for k, v in shapes.items()}
        out = ef.compress({k: torch.from_numpy(v) for k, v in grads.items()})
        want = ref.compress({k: jnp.asarray(v) for k, v in grads.items()})
        for k in shapes:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(ef.e[k].numpy(),
                                          np.asarray(ref.e[k]))


def test_error_feedback_recovers_small_signal():
    """A gradient component far below the quantization step is lost without
    EF but accumulates and eventually transmits with EF."""
    big, small = 1.0, 1e-4  # small « big/127 (one int8 quantum ≈ 7.9e-3)
    grads = {"w": torch.tensor([big, small], dtype=torch.float32)}
    ef = ErrorFeedback(grads)
    n = 400
    sent = np.zeros(2)
    for _ in range(n):
        sent += ef.compress(grads)["w"].numpy()
    quantum = big / 127.0
    assert abs(sent[1] - n * small) <= quantum + 1e-9
    assert sent[1] > 0  # without EF this is exactly 0 forever
    assert abs(sent[0] - n * big) / (n * big) < 1e-3


def test_error_feedback_convergence_quadratic():
    """SGD with int8+EF gradients still converges on a quadratic."""
    rng = np.random.default_rng(2)
    target = torch.tensor(rng.normal(size=(16,)), dtype=torch.float32)
    w = torch.zeros(16)
    ef = ErrorFeedback({"w": w})
    for _ in range(400):
        w = w - 0.05 * ef.compress({"w": 2 * (w - target)})["w"]
    assert float(((w - target) ** 2).sum()) < 1e-3


def test_compressed_psum_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises((RuntimeError, ValueError)):
        compressed_psum(torch.ones(3))


def test_compressed_psum_two_gloo_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_compress_ranks.py"),
         str(tmp_path), "2"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    grads = [torch_compress_ranks.gradient(r) for r in range(2)]
    # the reference's arithmetic (pmax of the amax, psum of int32, / n)
    amax = max(float(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(g))), 1e-30))
               for g in grads)
    scale = jnp.float32(amax) / 127.0
    total = sum(jnp.clip(jnp.round(jnp.asarray(g) / scale), -127, 127)
                .astype(jnp.int32) for g in grads)
    want = np.asarray(total.astype(jnp.float32) * scale / jnp.float32(2))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npy")
        np.testing.assert_array_equal(got, want)
        # and the mean itself, within one quantum
        assert np.abs(got - (grads[0] + grads[1]) / 2).max() <= float(scale)
