"""The LM model zoo's serving half: every family's prefill and decode.

``train_loss`` (and ``chunked_cross_entropy``) wait for the training half of
the port."""

from .model import (
    count_params,
    decode_step,
    init_caches,
    init_params,
    prefill,
)

__all__ = [
    "count_params", "decode_step", "init_caches", "init_params",
    "prefill",
]
