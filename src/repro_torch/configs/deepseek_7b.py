"""deepseek-7b [dense] — llama-arch, full MHA (kv=32) [arXiv:2401.02954]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,  # MHA
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    remat=False,
)
