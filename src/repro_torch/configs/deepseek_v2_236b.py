"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed experts
top-6, first layer dense [arXiv:2405.04434]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    attn_impl="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    d_ff=12288,  # the single leading dense layer
    vocab_size=102400,
    num_experts=160,
    experts_per_token=6,
    moe_d_ff=1536,
    num_shared_experts=2,
    first_k_dense=1,
    route_norm=False,  # DeepSeek-V2 does not renormalize top-k gates
    capacity_factor=1.5,
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    attn_impl="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    num_shared_experts=1,
    first_k_dense=1,
    route_norm=False,
    capacity_factor=2.0,
    remat=False,
)
