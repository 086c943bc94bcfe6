"""Optimizers, learning-rate schedules and the weight EMA of the port
(``repro.optim``)."""

from repro_torch.optim.optimizer import (  # noqa: F401
    AdamWConfig,
    Optimizer,
    adamw,
    apply_updates,
    global_norm,
    sgd_momentum,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    exponential_decay,
    warmup_cosine,
    warmup_exponential,
    warmup_linear,
)
from repro_torch.optim.ema import ema_init, ema_update  # noqa: F401
