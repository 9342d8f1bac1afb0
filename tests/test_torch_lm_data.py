"""The port's token pipeline (``repro_torch.data.lm_data``, a copy of the
reference's numpy code) against the JAX package's: batches and the bigram
entropy bit for bit, and the reference's determinism property
(``tests/test_trainer_ft.py``)."""

import numpy as np
import pytest

from repro.data.lm_data import TokenPipeline as RefPipeline

from repro_torch.data.lm_data import TokenPipeline


@pytest.mark.parametrize("kw", [
    dict(vocab_size=64, batch=2, seq_len=16, seed=3, branching=4),
    dict(vocab_size=49152, batch=2, seq_len=33, seed=17),
    dict(vocab_size=256, batch=3, seq_len=9, seed=0, mode="uniform"),
])
def test_batches_and_entropy_equal_reference(kw):
    port, ref = TokenPipeline(**kw), RefPipeline(**kw)
    for step in (0, 1, 7, 123_456):
        got, want = port(step), ref(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert port.bigram_entropy() == ref.bigram_entropy()


def test_data_pipeline_deterministic():
    p = TokenPipeline(vocab_size=64, batch=2, seq_len=16, seed=3, branching=4)
    b1, b2 = p(7), p(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], p(8)["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert 0 < p.bigram_entropy() < np.log(64)
