from .optimizer import OptState, adamw_update, global_norm, init_opt_state, lr_schedule
from .grad_compress import ErrorFeedback, compressed_psum, dequantize, quantize
from .trainer import Trainer, TrainerError

__all__ = [
    "OptState", "adamw_update", "global_norm", "init_opt_state", "lr_schedule",
    "ErrorFeedback", "compressed_psum", "dequantize", "quantize",
    "Trainer", "TrainerError",
]
