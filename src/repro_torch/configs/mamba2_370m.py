"""Mamba2-370M [arXiv:2405.21060; assignment: unverified].

48L, d_model 1024, attention-free SSD (state-space duality), ssm_state 128,
expand 2 (d_inner 2048), head_dim 64 → 32 SSD heads, conv width 4,
vocab 50280, tied embeddings.  O(1)-state decode → long_500k runs.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,  # mamba block replaces attention+FFN
    vocab_size=50280,
    layer_pattern=("mamba",),
    tie_embeddings=True,
    ssm_d_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_n_groups=1,
    conv_width=4,
    source="arXiv:2405.21060; unverified",
)
