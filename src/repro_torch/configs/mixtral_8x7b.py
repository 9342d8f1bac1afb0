"""Mixtral 8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1].

32L, d_model 4096, 32 heads (GQA kv=8), head_dim 128, vocab 32000,
MoE every layer: 8 experts top-2, d_ff 14336 per expert, sliding-window
attention 4096, untied embeddings.  SWA bounds decode caches →
long_500k runs.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # all layers MoE
    vocab_size=32000,
    rope_base=1_000_000.0,
    window=4096,
    layer_pattern=("local",),  # SWA on every layer
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    n_experts=8,
    top_k=2,
    d_ff_expert=14336,
    moe_every=1,
    # the reference's TPU tuning: a single q-chunk hoists attention
    # collectives (frac 0.059→0.081 on TPU); microbatches=4 keeps MoE
    # transients inside HBM
    q_chunk=4096,
    microbatches=4,
    source="arXiv:2401.04088; hf",
)
