"""The LM model zoo: every family's training loss, prefill and decode."""

from .model import (
    count_params,
    decode_step,
    init_caches,
    init_params,
    prefill,
    train_loss,
)

__all__ = [
    "count_params", "decode_step", "init_caches", "init_params",
    "prefill", "train_loss",
]
