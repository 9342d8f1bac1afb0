"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L, d_model 2048, 16 heads (MHA, kv=16), head_dim 128, vocab 50304,
MoE every layer: 64 experts, top-8, d_ff 1024 per expert, QK-norm,
full attention, untied embeddings.

Pure full attention → long_500k is skipped (see DESIGN §4).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,  # no dense FFN — every layer is MoE
    vocab_size=50304,
    rope_base=10_000.0,
    layer_pattern=("global",),
    qk_norm=True,
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    n_experts=64,
    top_k=8,
    d_ff_expert=1024,
    moe_every=1,
    microbatches=2,  # reference's TPU tuning (with EP, 2 fit HBM)
    source="arXiv:2409.02060; hf",
)
