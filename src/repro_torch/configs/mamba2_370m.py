"""mamba2-370m [ssm] — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    remat=False,
)
