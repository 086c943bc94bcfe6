"""Checkpointing of the port (``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    load_ledger,
    save_checkpoint,
)
