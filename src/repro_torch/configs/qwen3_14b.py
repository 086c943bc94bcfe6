"""qwen3-14b [dense] — qk-norm, GQA kv=8 [hf:Qwen/Qwen3-14B family]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=17408,
    vocab_size=151936,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    qk_norm=True,
    d_ff=128,
    vocab_size=256,
    rope_theta=1000000.0,
    remat=False,
)
