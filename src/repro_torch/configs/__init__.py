from .graphpm import PAPER_EVAL, GraphPMConfig

__all__ = ["PAPER_EVAL", "GraphPMConfig"]
