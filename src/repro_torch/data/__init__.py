from .synthetic_log import ProcessSpec, generate_memmap_log, generate_repository

__all__ = ["ProcessSpec", "generate_memmap_log", "generate_repository"]
