"""Gemma-3 12B [hf:google/gemma-3-12b-pt; assignment tier: unverified].

48L, d_model 3840, 16 heads (GQA kv=8), head_dim 256, d_ff 15360,
vocab 262144, 5:1 local:global interleave (local window 1024), dual RoPE
base (10k local / 1M global), QK-norm, gemma norm style (pre+post norms),
embeddings scaled by sqrt(d_model), tied.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_base=1_000_000.0,
    rope_base_local=10_000.0,
    window=1024,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    qk_norm=True,
    mlp_gated=True,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    post_norms=True,
    # the reference's TPU tuning: 256-token loss chunks + 2 microbatches fit
    # the 262k-vocab training step into HBM (19.1 → 13.6 GiB/chip on TPU)
    loss_chunk=256,
    microbatches=2,
    source="hf:google/gemma-3-1b-pt (family config, 12b dims); unverified",
)
