"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-34b-hf; assignment: unverified].

Yi-34B-class language backbone: 60L, d_model 7168, 56 heads (GQA kv=8),
head_dim 128, d_ff 20480, vocab 64000, RoPE, full attention, untied.
Anyres vision frontend is a STUB per the assignment brief: ``input_specs``
supplies precomputed patch embeddings (n_patches × d_model) that the model
prepends to the text embeddings; labels are masked over patch positions.

Pure full attention → long_500k is skipped (see DESIGN §4).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_base=5_000_000.0,  # Yi rope_theta
    layer_pattern=("global",),
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    n_patches=576,  # one 24×24 CLIP grid (anyres base tile), stubbed
    microbatches=2,  # reference's TPU tuning: train_4k fits (33.7 → 11.9 GiB)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (family); unverified",
)
