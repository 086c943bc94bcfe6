"""Synthetic data streams of the port, the paper's small datasets, the
recycle feed and the host prefetcher."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    Prefetcher,
    RecycleFeed,
    SyntheticLMStream,
    SyntheticRegression,
    mnist_like,
)
