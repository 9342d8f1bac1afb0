"""Gemma-2 27B [arXiv:2408.00118; hf:google/gemma-2-27b].

46L, d_model 4608, 32 heads (GQA kv=16), head_dim 128, d_ff 36864,
vocab 256000, alternating local(4096):global attention, attention-logit
softcap 50, final-logit softcap 30, query_pre_attn_scalar 144
(= d_model / n_heads), pre+post norms, scaled tied embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_base=10_000.0,
    window=4096,
    layer_pattern=("local", "global"),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=144.0,
    mlp_gated=True,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    post_norms=True,
    source="arXiv:2408.00118; hf",
)
