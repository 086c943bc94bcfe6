"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the modality
frontend (EnCodec + text conditioning) is a STUB: `prefix_embed` carries
precomputed conditioning frames per the assignment [arXiv:2306.05284]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,  # EnCodec codebook
    frontend="audio",
    prefix_len=64,  # stub conditioning frames
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    frontend="audio",
    prefix_len=8,
    remat=False,
)
