"""Optimizers of the port, with the protocol of ``repro.optim.optimizer``:
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; ``apply_updates(params, updates)``. Params, grads and
updates are nested dicts of tensors (``models.params`` trees).

The moments are f32 even for bf16 params (mixed precision), and the updates
are f32, cast to the param dtype when applied. ``update`` writes the new
moments into the state's tensors in place (the JAX version returns new
arrays) and returns that state: at llama3-8b width the moments are the
largest tensors of a train step, and a second copy of them would not fit
beside the rest. The step counter is a 0-dim int32 tensor on the params'
device, so nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models.params import tree_leaves, tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    return torch.sqrt(sum(x.to(F32).square().sum() for x in tree_leaves(tree)))


def apply_updates(params: Any, updates: Any) -> Any:
    """New params ``p + u`` with ``u`` cast to the param dtype first."""
    flat = tree_leaves(updates)
    it = iter(flat)
    return tree_map(lambda _, p: p + next(it).to(p.dtype), params)


def _zip_map(fn, *trees):
    """``fn(*leaves)`` over trees of one structure, in ``tree_map`` order."""
    its = [iter(tree_leaves(t)) for t in trees[1:]]
    return tree_map(lambda _, x: fn(x, *(next(i) for i in its)), trees[0])


def _clip(grads: Any, clip_norm: Optional[float]) -> Any:
    """f32 copies of the grads, scaled in place to ``clip_norm`` at most."""
    grads = tree_map(lambda _, g: g.to(F32, copy=True), grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / (global_norm(grads) + 1e-9), max=1.0)
        for g in tree_leaves(grads):
            g.mul_(scale)
    return grads


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0


def _step0(params: Any) -> torch.Tensor:
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(
    schedule: Callable[[torch.Tensor], torch.Tensor],
    cfg: AdamWConfig = AdamWConfig(),
) -> Optimizer:
    def init(params):
        zeros = lambda _, p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip(grads, cfg.clip_norm)

        def moments(mu, nu, g):
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())

        _zip_map(moments, state["m"], state["v"], grads)
        del grads  # free the f32 copies before the updates are made
        stepf = step.to(F32)
        c1 = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
        c2 = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
        lr = schedule(step)

        def upd(mu, nu, p):
            u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.to(F32)
            return -lr * u

        updates = _zip_map(upd, state["m"], state["v"], params)
        return updates, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


def sgd_momentum(
    schedule: Callable[[torch.Tensor], torch.Tensor],
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
) -> Optimizer:
    def init(params):
        zeros = lambda _, p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"step": _step0(params), "m": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip(grads, clip_norm)
        if weight_decay:
            grads = _zip_map(lambda g, p: g + weight_decay * p.to(F32),
                             grads, params)
        _zip_map(lambda mu, g: mu.mul_(momentum).add_(g), state["m"], grads)
        lr = schedule(step)
        updates = tree_map(lambda _, mu: -lr * mu, state["m"])
        return updates, {"step": step, "m": state["m"]}

    return Optimizer(init, update)
