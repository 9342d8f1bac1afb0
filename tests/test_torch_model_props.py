"""Model-level properties of the port's LM zoo on the CPU: the reference's
decode-matches-forward property (its own tolerance, rtol = atol = 2e-2,
``tests/test_models_smoke.py``), the exact parameter counts of the ten full
configs against the reference's (counted on the meta device, nothing
allocated), and the sliding-window cache bound."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import (
    count_params,
    decode_step,
    init_caches,
    init_params,
    prefill,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' products are tiny: one intra-op thread runs them
    fastest and does not contend with the other test workers' threads.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float(), dtype=np.float32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_forward(arch):
    """Prefill(S) then decode(token S) equals prefill(S+1)'s logits (the
    reference's property and tolerance, ``test_models_smoke.py``)."""
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        # drop-free routing: with finite capacity the (S+1)-token forward can
        # drop other tokens than the S-token prefill
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    S_ = 12 if cfg.family == "encdec" else 24
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, S_ + 1)))
    b_s, b_s1 = {"tokens": toks[:, :S_]}, {"tokens": toks}
    n_prefix = 0
    if cfg.family == "vlm":
        vis = torch.as_tensor(rng.normal(size=(1, cfg.n_patches, cfg.d_model)),
                              dtype=torch.float32)
        b_s["vision_embeds"] = b_s1["vision_embeds"] = vis
        n_prefix = cfg.n_patches
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.normal(size=(1, cfg.enc_seq, cfg.d_model)),
                                 dtype=torch.float32)
        b_s["frames"] = b_s1["frames"] = frames
    cache_len = S_ + 1 + n_prefix
    caches, _ = prefill(cfg, model, b_s, cache_len, q_chunk=16,
                        cache_dtype=torch.float32)
    logits_dec, _ = decode_step(cfg, model, toks[:, S_:], caches, S_ + n_prefix)
    _, logits_par = prefill(cfg, model, b_s1, cache_len + 1, q_chunk=16,
                            cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits_dec), _np(logits_par), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_counts_equal_reference(arch):
    """Full configs, counted on the meta device: total and active counts
    equal the reference's abstract-init counts."""
    rc, pc = ref_config(arch), get_config(arch)
    assert count_params(pc) == R.count_params(rc)
    assert count_params(pc, active_only=True) == R.count_params(
        rc, active_only=True)
    assert pc.params_count() == count_params(pc)
    assert pc.active_params_count() == count_params(pc, active_only=True)


def test_gemma2_9b_full_width_count():
    cfg = get_config("gemma2-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (42, 3584, 256_000)
    assert count_params(cfg) == 9_241_705_984


def test_sliding_window_cache_bounded():
    """Local layers do not allocate beyond the window."""
    cfg = get_config("mixtral-8x7b").reduced()
    caches = init_caches(cfg, batch=1, cache_len=1024)
    assert len(caches) == cfg.n_units
    assert caches[0]["e0"]["k"].shape[1] == cfg.window  # ring, not 1024
    g = get_config("gemma2-9b").reduced()
    c = init_caches(g, batch=2, cache_len=1024)[0]
    assert c["e0"]["k"].shape[1] == g.window  # local
    assert c["e1"]["k"].shape[1] == 1024  # global
