"""Synthetic data streams of the port and the recycle feed."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    RecycleFeed,
    SyntheticLMStream,
)
