"""The port's batched serving engine (``repro_torch.serve.ServeEngine``) on the
CPU: the reference's six engine tests on the port, greedy tokens equal to the
JAX ``ServeEngine``'s on the same weights (f32, ``.reduced()`` starcoder2-3b
and gemma2-9b), the self-mined telemetry's Ψ equal to the reference's (plain
and windowed) and to a count of the collector's own events, determinism at
temperature > 0, and the one-time weight cast that changes no output."""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import get_config as ref_config
from repro.core.telemetry import EventCollector as RefCollector
from repro.serve import ServeEngine as RefServeEngine

from repro_torch.configs import get_config
from repro_torch.core.telemetry import EventCollector
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import serving_weights
from repro_torch.serve import GenerationResult, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' products are tiny: one intra-op thread runs them
    fastest and does not contend with the other test workers' threads.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = get_config("starcoder2-3b").reduced()
    return dataclasses.replace(cfg, vocab_size=64, loss_chunk=8)


@pytest.fixture(scope="module")
def engine():
    cfg = _cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, ServeEngine(
        cfg, params, max_batch=4, max_cache=64, q_chunk=16, device="cpu"
    )


# ---------------------------------------------------------------------------
# The reference's engine tests, on the port
# ---------------------------------------------------------------------------


def test_generate_ragged_batch(engine):
    cfg, params, eng = engine
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11]]
    res = eng.generate(prompts, max_new_tokens=8)
    assert len(res) == 4
    for r, p in zip(sorted(res, key=lambda r: r.prompt), sorted(prompts)):
        assert r.prompt == p
    for r in res:
        assert isinstance(r, GenerationResult)
        assert len(r.tokens) == 8
        assert all(0 <= t < cfg.vocab_size for t in r.tokens)


def test_waves_beyond_max_batch(engine):
    cfg, params, eng = engine
    prompts = [[i + 1, i + 2] for i in range(10)]  # 10 > max_batch=4
    res = eng.generate(prompts, max_new_tokens=4)
    assert len(res) == 10


def test_ragged_equals_solo_greedy(engine):
    """Greedy decoding of a prompt is identical whether it is served alone
    or inside a ragged batch (per-seq positions are honored)."""
    cfg, params, eng = engine
    target = [5, 9, 2, 7]
    solo = eng.generate([target], max_new_tokens=6)[0].tokens
    batched = eng.generate(
        [[1], target, [3, 3, 3, 3, 3, 3, 3]], max_new_tokens=6
    )
    got = next(r for r in batched if r.prompt == target).tokens
    assert got == solo


def test_stop_token(engine):
    cfg, params, eng = engine
    res = eng.generate([[1, 2]], max_new_tokens=30, stop_token=None)[0]
    first = res.tokens[0]
    res2 = eng.generate([[1, 2]], max_new_tokens=30, stop_token=first)[0]
    assert res2.finished == "stop"
    assert len(res2.tokens) == 0


def test_telemetry_recorded(engine):
    cfg, params, eng = engine
    eng.generate([[1, 2, 3]], max_new_tokens=3)
    acts = set(eng.collector.to_repository().activity_names)
    assert "prefill" in acts and "decode" in acts


def test_mine_telemetry_through_query_engine(engine):
    """The serving engine's self-forensics DFG goes through the port's query
    engine, on the engine's device (here a CPU ``QueryEngine``)."""
    cfg, params, eng = engine
    eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    res = eng.mine_telemetry()
    assert eng._mining_engine().device.type == "cpu"
    assert "prefill" in res.names and "decode" in res.names
    p, d = res.names.index("prefill"), res.names.index("decode")
    assert res.value[p, d] >= 1
    assert res.value[d, d] >= 1


# ---------------------------------------------------------------------------
# Against the JAX ServeEngine
# ---------------------------------------------------------------------------


def _both(arch):
    rc = dataclasses.replace(ref_config(arch).reduced(), dtype="float32",
                             vocab_size=128)
    pc = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                             vocab_size=128)
    tree = jax.tree.map(np.asarray, R.init_params(rc, jax.random.PRNGKey(0)))
    return rc, pc, tree


def _prompts(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(2, 20))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-9b"])
def test_greedy_tokens_equal_reference_engine(arch):
    """Two waves of ragged prompts, greedy: the same tokens, the same
    finish reasons, with and without a stop token."""
    rc, pc, tree = _both(arch)
    ref = RefServeEngine(rc, tree, max_batch=4, max_cache=64, q_chunk=8)
    port = ServeEngine(pc, params_from_reference(pc, tree), max_batch=4,
                       max_cache=64, q_chunk=8, device="cpu")
    prompts = _prompts(pc.vocab_size)
    want = ref.generate(prompts, max_new_tokens=10)
    got = port.generate(prompts, max_new_tokens=10)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.prompt for r in got] == [r.prompt for r in want]
    stop = want[0].tokens[3]
    want = ref.generate(prompts, max_new_tokens=10, stop_token=stop)
    got = port.generate(prompts, max_new_tokens=10, stop_token=stop)
    assert [(r.tokens, r.finished) for r in got] == [
        (r.tokens, r.finished) for r in want]
    assert any(r.finished == "stop" for r in got)


def _oracle_psi(events, names, window=None):
    """Directly-follows counts of the collector's own events: per case,
    stably by time; with a window both endpoints in [t0, t1)."""
    by_case = collections.defaultdict(list)
    for case, act, ts in events:
        by_case[case].append((ts, act))
    psi = np.zeros((len(names), len(names)), np.int64)
    for evs in by_case.values():
        evs.sort(key=lambda e: e[0])
        for (t0, a), (t1, b) in zip(evs, evs[1:]):
            if window is None or (window[0] <= t0 < window[1]
                                  and window[0] <= t1 < window[1]):
                psi[names.index(a), names.index(b)] += 1
    return psi


def test_mine_telemetry_equals_reference_and_oracle(engine):
    """The port's engine mines its spans; the reference's engine, handed a
    collector with the same events, mines the same Ψ, plain and over a time
    window; both equal a count of the events themselves."""
    cfg = _cfg()
    col = EventCollector("server")
    eng = ServeEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                      max_batch=2, max_cache=64, q_chunk=16, collector=col,
                      device="cpu")
    eng.generate([[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [11, 12]],
                 max_new_tokens=5)
    events = list(zip(col._cases, col._activities, col._times))
    assert len({c for c, _, _ in events}) == 3  # one trace per wave
    ref_col = RefCollector("server")
    for case, act, ts in events:
        ref_col.record(case, act, timestamp=ts)
    # the reference engine only mines here: its model is never called
    ref_eng = RefServeEngine(ref_config("starcoder2-3b").reduced(), None,
                             collector=ref_col)
    times = sorted(ts for _, _, ts in events)
    window = (times[3], times[-4])
    for tw in (None, window):
        got, want = eng.mine_telemetry(tw), ref_eng.mine_telemetry(tw)
        assert list(got.names) == list(want.names)
        np.testing.assert_array_equal(np.asarray(got.value),
                                      np.asarray(want.value))
        np.testing.assert_array_equal(
            np.asarray(got.value), _oracle_psi(events, list(got.names), tw))


# ---------------------------------------------------------------------------
# The port's own choices
# ---------------------------------------------------------------------------


def test_sampling_is_deterministic_per_seed():
    """temperature > 0 draws from the engine's own generator: the same seed
    gives the same tokens, another seed other tokens, all valid ids."""
    cfg = _cfg()

    def run(seed):
        eng = ServeEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                          max_batch=4, max_cache=64, temperature=1.0,
                          seed=seed, device="cpu")
        return [r.tokens for r in eng.generate(_prompts(cfg.vocab_size, n=5),
                                               max_new_tokens=12)]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for toks in a for t in toks)


def test_serving_weights_cast_changes_no_output():
    """Casting the matrices to bf16 once gives bit-identical logits to
    casting them at each use; norms and SSM parameters stay f32."""
    for arch in ("gemma2-9b", "jamba-v0.1-52b"):
        cfg = get_config(arch).reduced()
        model = init_params(cfg, torch.Generator().manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(2, 9)))
        c0, want = prefill(cfg, model, {"tokens": toks}, 16, q_chunk=4)
        d_want, _ = decode_step(cfg, model, toks[:, :1], c0, 9)
        serving_weights(cfg, model)
        dtypes = {n: p.dtype for n, p in model.named_parameters()}
        assert dtypes["embed"] == torch.bfloat16
        assert all(dt == torch.float32 for n, dt in dtypes.items()
                   if n.rsplit(".", 1)[-1] in ("ln1", "final_norm", "A_log",
                                               "D", "dt_bias", "conv_w"))
        c1, got = prefill(cfg, model, {"tokens": toks}, 16, q_chunk=4)
        d_got, _ = decode_step(cfg, model, toks[:, :1], c1, 9)
        assert torch.equal(got, want) and torch.equal(d_got, d_want)
