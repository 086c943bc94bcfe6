"""Model configuration: a copy of ``repro.models.config.ModelConfig``.

The port runs every family, so one configuration describes a model in both
packages.

One decoder-LM family with feature flags: GQA/MQA, MLA, qk-norm, sliding-
window attention, MoE (top-k routing, shared experts, first-k-dense),
Mamba2/SSD blocks, Zamba2-style hybrid (shared attention block every k SSM
layers), and stub audio/vision frontends (precomputed prefix embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int

    # -- attention ----------------------------------------------------------
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # SWA (Mixtral); None = full causal
    attn_impl: str = "gqa"  # gqa | mla

    # -- MLA (DeepSeek-V2) ----------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # -- FFN ------------------------------------------------------------------
    d_ff: int = 0  # dense FFN size
    mlp_gelu: bool = False  # GPTBigCode-style 2-matrix GELU MLP (granite)

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert FFN size
    num_shared_experts: int = 0  # DeepSeek-V2 always-on experts
    first_k_dense: int = 0  # leading dense (non-MoE) layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    route_norm: bool = True  # renormalize top-k gates (Mixtral yes, DSv2 no)
    # tokens per dispatch group (GShard "G"): dispatch/combine one-hots are
    # [G, S, E, C] with C ∝ S, so their volume scales with group size —
    # smaller groups cut MoE activation memory/traffic linearly (capacity
    # variance rises slightly; cf absorbs it). 0 = one group per sequence.
    moe_group: int = 0

    # -- SSM (Mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1

    # -- hybrid (Zamba2) --------------------------------------------------------
    hybrid_attn_every: int = 0  # shared attention block each k SSM layers

    # -- frontend stubs -----------------------------------------------------
    frontend: Optional[str] = None  # "audio" | "vision"
    prefix_len: int = 0  # precomputed frontend embeddings per sequence

    # -- sharding -------------------------------------------------------------
    # per-arch logical-axis overrides, e.g. Mixtral's 8 experts don't divide
    # a 16-way model axis: shard the expert FFN dim over "model" instead.
    shard_overrides: tuple = ()  # (("experts", None), ("expert_mlp", "model"))

    # -- misc -----------------------------------------------------------------
    # sequences at/above this length use blocked (flash-style) attention on
    # the XLA path; the Pallas kernels make it moot on real TPU
    blocked_attn_min: int = 8192
    # decode KV cache precision: "bf16" or "int8" (per-(pos, head) scales;
    # halves the HBM reads that bound decode AND doubles cache capacity)
    kv_cache_dtype: str = "bf16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True  # activation checkpointing around each scanned layer

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """May run the long_500k cell (spec: SSM / hybrid / windowed attn)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    def validate(self) -> "ModelConfig":
        if self.family in ("dense", "moe", "audio", "vlm"):
            assert self.num_heads > 0 and self.d_ff >= 0
            if self.attn_impl == "gqa":
                assert self.head_dim > 0 and self.num_heads % max(self.num_kv_heads, 1) == 0
            if self.attn_impl == "mla":
                assert self.kv_lora_rank > 0 and self.v_head_dim > 0
        if self.family == "ssm":
            assert self.ssm_state > 0 and self.d_inner % self.ssm_head_dim == 0
        if self.family == "hybrid":
            assert self.hybrid_attn_every > 0
            assert self.num_layers % self.hybrid_attn_every == 0
        if self.uses_moe:
            assert 0 < self.experts_per_token <= self.num_experts
        return self
