"""Gemma-2 9B [arXiv:2408.00118; hf:google/gemma-2-9b].

42L, d_model 3584, 16 heads (GQA kv=8), head_dim 256, d_ff 14336,
vocab 256000, alternating local(4096):global, softcaps 50/30,
query_pre_attn_scalar 256 (= head_dim).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_base=10_000.0,
    window=4096,
    layer_pattern=("local", "global"),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=256.0,
    mlp_gated=True,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    post_norms=True,
    source="arXiv:2408.00118; hf",
)
