"""Jamba v0.1 52B [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1].

32L in 4 Jamba blocks of 8: attention at in-block index 4, Mamba elsewhere
(1:7 attn:mamba); MoE (16 experts, top-2, d_ff 14336) every other layer,
dense d_ff 14336 otherwise.  d_model 4096, 32 heads (GQA kv=8), vocab 65536.

As in the reference package, Jamba's Mamba-1 layers are realized with the
Mamba-2 SSD formulation (d_state 16 preserved, scalar-A-per-head): the
selective scan's chunked-matmul dual.

Hybrid (bounded state + 4 attention layers) → long_500k runs.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope_base=0.0,  # jamba uses no positional encoding on attention
    layer_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "global", "mamba", "mamba", "mamba",
    ),
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,  # every other layer is MoE
    ssm_d_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_n_groups=1,
    conv_width=4,
    source="arXiv:2403.19887; hf",
)
