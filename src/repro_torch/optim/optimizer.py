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

``adamw(..., layout=)`` runs on the data axis's layout
(``distributed.zero.DataLayout``): the params and grads come as the rank
holds them, the FSDP'd leaves as this rank's slices (their grads already
reduce-scattered), the others whole (their grads all-reduced). Each rank
keeps its slice of each moment leaf and updates it from its slice of the
grads and params; the updates of the sliced params stay slices, applied in
place of the rank's own, and those of the params held whole are gathered
from every rank's slices (ZeRO-1). The clip's global norm is the full
grads' (``global_norm(grads, layout)``: one all-reduce of the slices' sums
of squares), so its scale is the same on every rank. ``sgd_momentum(...,
layout=)`` keeps its momentum as the params are held (elementwise, so a
slice updates a slice) and clips by the same global norm. The optimizer
carries its layout (``Optimizer.layout``): the data-parallel train step
reads it from there, so the step and the optimizer cannot disagree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed import compat
from repro_torch.distributed.zero import REPLICATED
from repro_torch.models.params import tree_leaves, tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    # the data axis's ``distributed.zero.DataLayout`` its state is held in
    # (None: one device, every leaf whole)
    layout: Any = None


def global_norm(tree: Any, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor).
    With ``layout`` (a ``distributed.zero.DataLayout``) the tree is held
    as the params are: the full tree's norm is taken from the sum over
    ranks of the sliced leaves' sums of squares (one all-reduce, a
    collective) plus the whole leaves' own, counted once."""
    sq = [x.to(F32).square().sum() for x in tree_leaves(tree)]
    if layout is None or layout.shards == 1:
        return torch.sqrt(sum(sq))
    held = layout.held_mask()
    zero = torch.zeros((), dtype=F32, device=sq[0].device)
    part = sum((s for s, h in zip(sq, held) if h), zero)
    whole = sum((s for s, h in zip(sq, held) if not h), zero)
    return torch.sqrt(compat.all_reduce_sum(part) + whole)


def apply_updates(params: Any, updates: Any) -> Any:
    """New params ``p + u`` with ``u`` cast to the param dtype first."""
    flat = tree_leaves(updates)
    it = iter(flat)
    return tree_map(lambda _, p: p + next(it).to(p.dtype), params)


def _zip_map(fn, *trees):
    """``fn(*leaves)`` over trees of one structure, in ``tree_map`` order."""
    its = [iter(tree_leaves(t)) for t in trees[1:]]
    return tree_map(lambda _, x: fn(x, *(next(i) for i in its)), trees[0])


def _clip(grads: Any, clip_norm: Optional[float], layout=None,
          moments: bool = False) -> Any:
    """f32 copies of the grads (held as ``layout`` holds the params; with
    ``moments``, of this rank's moment slices of them), scaled in place so
    that the full grads' global norm is ``clip_norm`` at most."""
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(
            clip_norm / (global_norm(grads, layout) + 1e-9), max=1.0)
    if moments:
        grads = layout.slice(grads, REPLICATED)
    grads = tree_map(lambda _, g: g.to(F32, copy=True), grads)
    if scale is not None:
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
    layout=None,
) -> Optimizer:
    """AdamW; with ``layout`` (a ``distributed.zero.DataLayout``) the
    params, grads and updates are held in it, the moments hold this
    rank's slices, and ``update`` is a collective (the clip's norm, the
    gather of the whole params' updates): every rank of the data axis
    calls it."""
    cut = ((lambda t: t) if layout is None
           else (lambda t: layout.slice(t, REPLICATED)))

    def init(params):
        zeros = lambda _, p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"step": _step0(params), "m": tree_map(zeros, cut(params)),
                "v": tree_map(zeros, cut(params))}

    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip(grads, cfg.clip_norm, layout, layout is not None)

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

        updates = _zip_map(upd, state["m"], state["v"], cut(params))
        if layout is not None:
            updates = layout.gather(updates, REPLICATED)
        return updates, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update, layout)


def sgd_momentum(
    schedule: Callable[[torch.Tensor], torch.Tensor],
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
    layout=None,
) -> Optimizer:
    """SGD with momentum; with ``layout`` the params, grads, momentum and
    updates are held in it (the clip's norm is then a collective)."""

    def init(params):
        zeros = lambda _, p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"step": _step0(params), "m": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip(grads, clip_norm, layout)
        if weight_decay:
            grads = _zip_map(lambda g, p: g + weight_decay * p.to(F32),
                             grads, params)
        _zip_map(lambda mu, g: mu.mul_(momentum).add_(g), state["m"], grads)
        lr = schedule(step)
        updates = tree_map(lambda _, mu: -lr * mu, state["m"])
        return updates, {"step": step, "m": state["m"]}

    return Optimizer(init, update, layout)
