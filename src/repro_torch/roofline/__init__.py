from . import hw
from .analyze import analyze_step, model_flops, parse_collectives

__all__ = ["hw", "analyze_step", "model_flops", "parse_collectives"]
