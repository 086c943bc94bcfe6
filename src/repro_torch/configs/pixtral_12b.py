"""pixtral-12b [vlm] — mistral-nemo-style backbone; pixtral-ViT frontend is a
STUB: `prefix_embed` carries precomputed patch embeddings per the assignment
[hf:mistralai/Pixtral-12B-2409]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000000.0,
    frontend="vision",
    prefix_len=1024,  # stub image patches
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    rope_theta=1000000000.0,
    frontend="vision",
    prefix_len=8,
    remat=False,
)
