"""Model + input-shape configuration.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes as :class:`ShapeConfig`.  The port's copy of the
reference's configs: the same fields and defaults, so a config means the
same model in both packages.  CPU tests instantiate ``reduced()`` copies;
``chip_smoke.py`` serves gemma2-9b at full width on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "TrainHParams"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants -------------------------------------------------
    rope_base: float = 10_000.0
    rope_base_local: Optional[float] = None  # gemma3 dual-base (local layers)
    window: Optional[int] = None  # sliding window for "local"/SWA layers
    # repeating unit of layer kinds; n_layers % len(pattern) == 0.
    # kinds: "global" (full causal attn), "local" (windowed attn), "mamba"
    layer_pattern: Tuple[str, ...] = ("global",)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # gemma2 query_pre_attn_scalar
    qk_norm: bool = False

    # --- mlp ------------------------------------------------------------------
    mlp_gated: bool = True
    act: str = "silu"  # silu | gelu

    # --- embeddings -------------------------------------------------------------
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma: embed * sqrt(d_model)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1  # 1: every layer MoE; 2: every other (jamba)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba-2 SSD) ---------------------------------------------------
    ssm_d_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_n_groups: int = 1
    conv_width: int = 4

    # --- encoder–decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frame embeddings (stub frontend)

    # --- VLM stub (llava) ------------------------------------------------------
    n_patches: int = 0  # precomputed patch embeddings prepended to text

    # --- training memory -------------------------------------------------------
    # gradient-accumulation microbatches (0 = auto: MoE archs accumulate so
    # dispatch transients fit HBM; dense archs run the full batch)
    microbatches: int = 0

    # --- distribution tuning (the reference's TPU sharding; the port on one
    # card reads none of these yet) ---------------------------------------------
    # "auto": constrain q/k/v to an explicit head-axis sharding (KV or G,
    # whichever pads least on the model axis) so attention scores stay local
    # — without it GSPMD shards the head_dim *contraction* and all-reduces
    # the scores tensor per q-chunk (the reference measured 3.6 TB/device
    # on llava prefill, on TPU).
    # "none": leave attention layouts to GSPMD (the recorded baseline).
    attn_head_shard: str = "auto"
    # attention q-chunk (0 = auto: 512 beyond 8k context, else 1024);
    # bigger chunks amortize per-chunk collectives, cost more VMEM/HBM
    q_chunk: int = 0
    # shard the expert dim over `model` when divisible (EP) instead of
    # TP-inside-every-expert — cuts FSDP weight-gather traffic |E|-fold
    moe_expert_parallel: bool = True
    # cast matrix params to bf16 once at step entry (before the FSDP
    # all-gathers) — halves weight-gather wire bytes; master weights stay
    # f32 in the optimizer (standard mixed precision)
    cast_params_once: bool = True

    # --- norms / numerics ------------------------------------------------------
    rms_eps: float = 1e-6
    post_norms: bool = False  # gemma2/3 post-attn & post-ffn norms
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"  # none | full | dots
    loss_chunk: int = 512  # sequence chunking for the vocab projection

    # --- provenance -------------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_units(self) -> int:
        assert self.n_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern {len(self.layer_pattern)}"
        )
        return self.n_layers // len(self.layer_pattern)

    def is_moe_layer(self, idx_in_pattern: int) -> bool:
        if self.n_experts == 0:
            return False
        return (idx_in_pattern % self.moe_every) == (self.moe_every - 1)

    @property
    def has_attention(self) -> bool:
        return any(k in ("global", "local") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer kind requires unbounded full attention context
        (window'd or SSM everywhere) OR the arch is attention-free/hybrid —
        used for the long_500k run/skip decision together with family."""
        kinds = set(self.layer_pattern)
        if "global" not in kinds:
            return True
        # hybrids / local-global mixes: bounded-per-step decode, allowed
        return self.family in ("ssm", "hybrid") or "local" in kinds or "mamba" in kinds

    def params_count(self) -> int:
        """Total parameters (exact, mirrors init_params)."""
        from repro_torch.models.model import count_params  # lazy, avoids cycle

        return count_params(self)

    def active_params_count(self) -> int:
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """A CPU-smoke-test-sized config of the same family/shape class."""
        pat = self.layer_pattern
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=len(pat) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            d_ff_expert=32 if self.n_experts else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_d_state=min(self.ssm_d_state, 16),
            ssm_head_dim=16 if self.ssm_d_state else self.ssm_head_dim,
            ssm_chunk=8,
            window=min(self.window, 8) if self.window else None,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_seq=16 if self.enc_seq else 0,
            n_patches=8 if self.n_patches else 0,
            loss_chunk=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient-accumulation factor
