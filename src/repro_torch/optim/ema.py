"""Exponential moving average of model weights (paper §4.3 uses EMA
0.9999), over the port's parameter trees (``models.params``), in f32."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import tree_leaves, tree_map

F32 = torch.float32


def ema_init(params: Any) -> Any:
    """f32 copies of every leaf."""
    return tree_map(lambda _, p: p.to(F32, copy=True), params)


def ema_update(ema: Any, params: Any, momentum: float = 0.9999) -> Any:
    """A new tree ``momentum * ema + (1 - momentum) * params`` in f32."""
    it = iter(tree_leaves(params))
    return tree_map(
        lambda _, e: momentum * e + (1.0 - momentum) * next(it).to(F32), ema)
