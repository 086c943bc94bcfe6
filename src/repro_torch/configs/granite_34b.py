"""granite-34b [dense] — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    head_dim=128,
    d_ff=24576,
    mlp_gelu=True,  # GPTBigCode arch
    vocab_size=49152,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=160,
    mlp_gelu=True,
    vocab_size=256,
    remat=False,
)
