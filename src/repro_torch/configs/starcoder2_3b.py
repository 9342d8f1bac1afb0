"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b].

30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152, RoPE,
sliding-window attention 4096 (HF config), non-gated GELU MLP, tied embeds.
SWA bounds the decode cache → long_500k runs with a window cache.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_base=999_999.4,  # hf rope_theta
    window=4096,
    layer_pattern=("local",),  # every layer sliding-window (hf config)
    mlp_gated=False,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2402.19173; hf",
)
