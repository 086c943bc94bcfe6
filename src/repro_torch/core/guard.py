"""The host-sync guard of the port's warm device steps."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_host_sync(enabled: bool):
    """Make any host synchronisation inside the block raise (CUDA only):
    ``torch.cuda.set_sync_debug_mode("error")``, the twin of the JAX
    package's ``transfer_guard("disallow")``."""
    if not enabled:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
