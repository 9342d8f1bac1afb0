"""Config registry: one module per assigned architecture + input shapes,
and the paper's own workload (``PAPER_EVAL``, ``BENCH_FAST``)."""

from .base import SHAPES, ModelConfig, ShapeConfig, TrainHParams
from .graphpm import BENCH_FAST, PAPER_EVAL, GraphPMConfig

from . import (
    gemma2_9b,
    gemma2_27b,
    gemma3_12b,
    jamba_v01_52b,
    llava_next_34b,
    mamba2_370m,
    mixtral_8x7b,
    olmoe_1b_7b,
    starcoder2_3b,
    whisper_tiny,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        starcoder2_3b,
        gemma3_12b,
        gemma2_27b,
        gemma2_9b,
        llava_next_34b,
        olmoe_1b_7b,
        mixtral_8x7b,
        mamba2_370m,
        whisper_tiny,
        jamba_v01_52b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


# long_500k applicability: skip for pure full-attention archs.
LONG_CONTEXT_SKIPS = {"llava-next-34b", "olmoe-1b-7b", "whisper-tiny"}


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells per the assignment."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            if (
                not include_skips
                and shape == "long_500k"
                and arch in LONG_CONTEXT_SKIPS
            ):
                continue
            out.append((arch, shape))
    return out


__all__ = [
    "ARCHS", "SHAPES", "LONG_CONTEXT_SKIPS",
    "GraphPMConfig", "PAPER_EVAL", "BENCH_FAST",
    "ModelConfig", "ShapeConfig", "TrainHParams",
    "get_config", "get_shape", "cells",
]
