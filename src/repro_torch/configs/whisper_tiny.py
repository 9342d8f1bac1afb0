"""Whisper-tiny [arXiv:2212.04356; assignment: unverified].

Encoder–decoder: 4 encoder + 4 decoder layers, d_model 384, 6 heads
(kv=6, head_dim 64), d_ff 1536, vocab 51865.  The conv/mel frontend is a
STUB per the assignment brief: ``input_specs`` supplies precomputed frame
embeddings (1500 × 384); the encoder runs bidirectional attention over
them, the decoder decodes tokens with self- + cross-attention.

Enc-dec with a decoder → decode shapes run; long_500k skipped (full
attention, DESIGN §4).  Non-gated GELU MLP, learned abs positions
(decoder) / sinusoidal (encoder), tied decoder embedding.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    rope_base=0.0,  # whisper uses absolute positions, not RoPE
    layer_pattern=("global",),
    mlp_gated=False,
    act="gelu",
    tie_embeddings=True,
    n_enc_layers=4,
    enc_seq=1500,
    source="arXiv:2212.04356; unverified",
)
