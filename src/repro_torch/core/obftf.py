"""OBFTF train step (paper Algorithm 1) on one device.

The PyTorch counterpart of ``repro.core.obftf`` without a mesh. Per batch:
  4: forward the whole batch, no autograd               (the "ten forward")
  5: per-example losses
  6: pick a subset whose mean loss matches the batch's  -> indices
  7: keep the selected examples
  8: forward and backward on the kept subset only       (the "one backward")
With ``recycle_forward`` and a ``recorded_loss`` in the batch, steps 4-5 are
skipped and the recorded losses stand in for them.

The step reads nothing back to the host: selection, the gather, the
optimizer and every metric stay on the device as tensors, so on the card a
warm step runs under ``torch.cuda.set_sync_debug_mode("error")``.

Step cost (C = one full-batch forward): dense 3C; OBFTF (1 + 3r)C; OBFTF
with recycled forwards 3rC, r the selection ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.selection import Noise, SelectionConfig, select
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import Optimizer, apply_updates, global_norm

Batch = dict[str, torch.Tensor]
F32 = torch.float32

# Batch keys that are per-example metadata, not model inputs.
META_KEYS = ("recorded_loss", "instance_id", "priority")


@dataclasses.dataclass(frozen=True)
class OBFTFConfig:
    selection: SelectionConfig = SelectionConfig()
    # reuse serving-time losses in batch["recorded_loss"] instead of a
    # selection forward
    recycle_forward: bool = False
    mode: str = "obftf"  # "obftf", or "full": backward on every example
    # accepted for configuration parity with the JAX package; one device
    # holds one shard, so shard-local and global selection coincide
    shard_local: bool = True


def model_inputs(batch: Batch) -> Batch:
    return {k: v for k, v in batch.items() if k not in META_KEYS}


def select_and_gather(
    cfg: SelectionConfig, noise: Noise, losses: torch.Tensor, batch: Batch
) -> tuple[Batch, torch.Tensor, torch.Tensor]:
    """Steps 6-7 -> (sub_batch, indices [b] int64, selected losses [b])."""
    b = cfg.budget(losses.shape[0])
    idx = select(cfg, noise, losses.to(F32), b)
    sub = {k: v.index_select(0, idx) for k, v in batch.items()}
    return sub, idx, losses.index_select(0, idx)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=device)


def _detached(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple):
        return tuple(_detached(v) for v in x)
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    return x


def loss_and_grads(fn: Callable, params: Any, inputs: Any):
    """(``fn(params, inputs)`` detached, the grads of the mean of its
    per-example losses as a tree shaped like ``params``). ``fn`` returns
    the losses [n], or a tuple led by them whose other entries are
    returned beside them, never differentiated. An empty leaf (a stack
    of no layers, such as a moe model cut to its ``first_k_dense`` layers)
    takes no part in the loss; its grad is an empty tensor."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(live)
    out = fn(tree_map(lambda _, p: next(it), params), inputs)
    pel = out[0] if isinstance(out, tuple) else out
    used = [p for p in live if p.numel()]
    grads = iter(torch.autograd.grad(pel.mean(), used))
    return _detached(out), tree_map(
        lambda _, p: next(grads) if p.numel() else torch.zeros_like(p),
        params)


def make_train_step(
    per_example_loss_fn: Callable[[Any, Batch], torch.Tensor],
    optimizer: Optimizer,
    cfg: OBFTFConfig,
):
    """Build ``train_step(state, batch, noise) -> (state, metrics)``.

    state = {"params": tree, "opt": optimizer state, "step": 0-dim int32};
    batch = {"tokens", "labels"[, "recorded_loss", "instance_id"]}, leaves
    leading with the batch dim; ``noise`` supplies the selection's draws.
    The returned state is new, except the optimizer's moments, which
    ``optimizer.update`` advances in place. Metrics are device tensors:
    those of the JAX step, plus ``selected``, the kept rows' indices."""
    sel = cfg.selection

    def train_step(state: dict, batch: Batch, noise: Noise):
        params = state["params"]
        inputs = model_inputs(batch)
        dev = state["step"].device

        if cfg.mode == "full":
            per_example, grads = loss_and_grads(per_example_loss_fn, params,
                                                inputs)
            per_example = per_example.to(F32)
            loss = per_example.mean()
            sel_losses = loss.reshape(1)
            residual = _scalar(0.0, dev)
            n = next(iter(inputs.values())).shape[0]
            per_example_fresh = torch.ones((n,), dtype=torch.bool, device=dev)
            sel_idx = torch.arange(n, device=dev)
            kept, step_cost = float(n), 3.0
        else:
            # 4-5: the "inference" forward, no autograd
            recycled = cfg.recycle_forward and "recorded_loss" in batch
            if recycled:
                losses = batch["recorded_loss"].to(F32)
            else:
                with torch.no_grad():
                    losses = per_example_loss_fn(params, inputs).to(F32)
            n = losses.shape[0]
            # 6-7: subset selection over the whole batch
            sub_batch, sel_idx, sel_losses = select_and_gather(
                sel, noise, losses, batch)
            residual = torch.abs(sel_losses.mean() - losses.mean())
            kept = float(sel_losses.shape[0])
            step_cost = (0.0 if recycled else 1.0) + 3.0 * kept / n
            # 8: one backward on the kept subset; its per-example losses
            # fall out of the same forward
            sub_losses, grads = loss_and_grads(
                per_example_loss_fn, params, model_inputs(sub_batch))
            loss = sub_losses.to(F32).mean()
            per_example = losses.index_put((sel_idx,), sub_losses.to(F32))
            per_example_fresh = (
                torch.zeros((n,), dtype=torch.bool, device=dev).index_fill(
                    0, sel_idx, True)
                if recycled
                else torch.ones((n,), dtype=torch.bool, device=dev)
            )

        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state["opt"], params)
            del grads
            new_state = {
                "params": apply_updates(params, updates),
                "opt": opt_state,
                "step": state["step"] + 1,
            }
            metrics = {
                "loss": loss,
                "selected_mean_loss": sel_losses.mean(),
                "selection_residual": residual,
                "kept": _scalar(kept, dev),
                "step_cost": _scalar(step_cost, dev),
                "grad_norm": global_norm(updates),
                # true per-instance signals aligned to the in-batch index;
                # `fresh` marks entries computed this step
                "per_example_loss": per_example,
                "per_example_fresh": per_example_fresh,
                # the kept rows' batch positions (not among the JAX step's
                # metrics, which keeps them inside the jit)
                "selected": sel_idx,
            }
        return new_state, metrics

    return train_step


def step_cost_savings(step_cost) -> float:
    """Fraction of the dense step's compute a step saved, from the
    ``step_cost`` metric (units of one full-batch forward; dense is 3C).
    Negative would mean selection cost more than the subset saved: not
    clamped."""
    return 1.0 - float(step_cost) / 3.0


def make_eval_step(per_example_loss_fn: Callable[[Any, Batch], torch.Tensor]):
    def eval_step(params: Any, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            return per_example_loss_fn(params, model_inputs(batch))

    return eval_step
