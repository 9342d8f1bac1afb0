"""The port's oracle names of ``kernels/dfg_count`` (``dfg_count_ref``,
``dfg_count_diced_ref``) against the JAX package's ``ref.py`` on the same
seeded inputs: ids outside ``[0, A)`` (negative and too large) count 0,
``valid`` counts by its value, and Ψ is int32 — bit for bit.  Timestamps
are whole seconds below 2²⁴, so the reference's f32 window compares the
same values as the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.dfg_count as R
import repro_torch.kernels.dfg_count as T

CASES = [(1, 7, 200), (2, 33, 5_000), (3, 1, 64), (4, 250, 20_000)]


def _inputs(seed, a, n):
    rng = np.random.default_rng(seed)
    src = rng.integers(-3, a + 3, n).astype(np.int32)
    dst = rng.integers(-3, a + 3, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    ts_src = rng.integers(0, 10_000, n).astype(np.float64)
    ts_dst = ts_src + rng.integers(0, 50, n)
    return src, dst, valid, ts_src, ts_dst


def test_exports_match_the_reference():
    for name in ("ref", "dfg_count_ref", "dfg_count_diced_ref"):
        assert name in R.__all__ and name in T.__all__
    assert T.ref.__all__ == R.ref.__all__


@pytest.mark.parametrize("seed, a, n", CASES)
def test_dfg_count_ref_matches_reference(seed, a, n):
    src, dst, valid, _, _ = _inputs(seed, a, n)
    want = np.asarray(R.dfg_count_ref(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(valid), num_activities=a))
    got = T.dfg_count_ref(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(valid), num_activities=a)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the out-of-range rows are what the oracle drops, and they exist here
    out = (src < 0) | (src >= a) | (dst < 0) | (dst >= a)
    assert (out & valid).any() and int(got.sum()) == int((valid & ~out).sum())


@pytest.mark.parametrize("seed, a, n", CASES)
def test_dfg_count_diced_ref_matches_reference(seed, a, n):
    src, dst, valid, ts_src, ts_dst = _inputs(seed, a, n)
    window = np.asarray([2_000.0, 7_500.0])
    want = np.asarray(R.dfg_count_diced_ref(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
        jnp.asarray(ts_src), jnp.asarray(ts_dst), jnp.asarray(window),
        num_activities=a))
    got = T.dfg_count_diced_ref(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
        torch.from_numpy(ts_src), torch.from_numpy(ts_dst),
        torch.from_numpy(window), num_activities=a)
    np.testing.assert_array_equal(got.numpy(), want)


def test_valid_counts_by_its_value():
    """An integer ``valid`` adds its value, as the reference's does."""
    src = np.asarray([0, 1, 1, 5], np.int32)
    dst = np.asarray([1, 1, 1, 0], np.int32)
    valid = np.asarray([2, 1, 3, 7], np.int32)
    want = np.asarray(R.dfg_count_ref(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(valid), num_activities=3))
    got = T.dfg_count_ref(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(valid), num_activities=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 1] == 4 and got.sum() == 6


def test_ref_agrees_with_the_plain_version():
    """On boolean ``valid``, the oracle and the wrapper's plain version
    (int64) give the same counts."""
    src, dst, valid, _, _ = _inputs(5, 40, 3_000)
    got = T.dfg_count_ref(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(valid), num_activities=40)
    plain = T.dfg_count_plain(src, dst, valid, num_activities=40)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
