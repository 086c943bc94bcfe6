"""mixtral-8x22b [moe] — 8 experts top-2, SWA per assignment
[arXiv:2401.04088]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,  # no dense layers
    vocab_size=32768,
    sliding_window=4096,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    route_norm=True,
    capacity_factor=2.0,
    rope_theta=1000000.0,
    # 8 experts don't divide the 16-way model axis: keep experts local,
    # shard each expert's FFN dim over "model" (Megatron-style within expert)
    shard_overrides=(("experts", None), ("expert_mlp", "model")),
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    sliding_window=16,
    num_experts=4,
    experts_per_token=2,
    moe_d_ff=64,
    route_norm=True,
    capacity_factor=2.0,
    rope_theta=1000000.0,
    remat=False,
)
