"""OBFTF train step (paper Algorithm 1), on one device or data-parallel.

The PyTorch counterpart of ``repro.core.obftf``. Per batch:
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

With a mesh (``launch.mesh.Mesh``; one rank a device, the data axis a
process group), each rank takes its segment of the global batch, rows
``[r*n_local, (r+1)*n_local)`` (JAX's ``P("data")``), and the step equals
the JAX package's ``make_train_step(mesh=, dp_axes=)`` on the global batch:

* shard-local selection (``shard_local=True``, JAX's ``shard_map``): each
  rank keeps ``budget(n_local)`` rows of its own segment, with its own
  draws; no example crosses a rank. ``S * budget(n_local)`` can differ
  from ``budget(n)`` (ratio 0.3, n 32, S 4 keeps 8, not 10), as in JAX;
* global selection (``shard_local=False``): the losses are all-gathered,
  every rank selects ``budget(n)`` rows with the same draws, and rank r
  trains rows ``[r*b/S, (r+1)*b/S)`` of the kept list, taken from the
  all-gathered batch, so no shape depends on the data (``b % S`` must be
  0);
* each rank differentiates the sum of its kept rows' losses over the
  GLOBAL kept count: JAX's mean over the global sub-batch (not a mean of
  per-rank means);
* the params are placed as the JAX trainer places them, in the layout
  the optimizer was built with (``distributed.zero.DataLayout``,
  ``adamw(layout=)``): each rank holds its slice of every leaf whose
  spec names ``data`` (FSDP) and the others whole. The step runs under
  ``distributed.sharding.use_rules`` with the layout's rules, so each
  layer gathers its weights when it runs, in every forward (the
  selection forward included) and in the backward's recompute, and the
  backward reduce-scatters their grads: the sliced leaves' grads come out
  summed over the ranks, and one all-reduce a dtype bucket sums the
  others'. AdamW updates the slices in place of the rank's own and
  gathers only the whole params' updates;
* every rank runs the same forwards, layers and backwards in the same
  order (each gather is a collective), and no shape depends on the data.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.selection import Noise, SelectionConfig, select
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import use_rules
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
    # with a mesh: True selects within each rank's segment (no example
    # crosses a rank); False selects over the whole batch (the paper's
    # exact formulation). Without a mesh the two coincide.
    shard_local: bool = True


def model_inputs(batch: Batch) -> Batch:
    return {k: v for k, v in batch.items() if k not in META_KEYS}


def _dp_shard_count(mesh, dp_axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes)


def fold_seed(seed: int, rank: int) -> int:
    """A generator seed of rank ``rank``'s own draws from the run's
    ``seed``: the counterpart of JAX's ``fold_in(key, rank)`` (other
    numbers, the same role)."""
    key = f"{seed}/rank{rank}".encode()
    return int.from_bytes(hashlib.md5(key).digest()[:8], "little") >> 1


def select_and_gather(
    cfg: SelectionConfig, noise: Noise, losses: torch.Tensor, batch: Batch,
    *, mesh=None,
) -> tuple[Batch, torch.Tensor, torch.Tensor]:
    """Steps 6-7 -> (sub_batch, indices int64, selected losses).

    Without a mesh: ``budget(n)`` rows of the whole batch. With one,
    shard-local: ``losses`` and ``batch`` are this rank's segment of
    ``n_local`` rows, ``noise`` this rank's own draws; it keeps
    ``budget(n_local)`` of them, and the indices are GLOBAL batch
    positions (offset by ``rank * n_local``), as JAX's are. No collective
    runs."""
    n = losses.shape[0]
    b = cfg.budget(n)
    idx = select(cfg, noise, losses.to(F32), b)
    sub = {k: v.index_select(0, idx) for k, v in batch.items()}
    offset = 0 if mesh is None else compat.linear_axis_index() * n
    return sub, idx + offset, losses.index_select(0, idx)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=device)


def _mask(n: int, idx: torch.Tensor, device) -> torch.Tensor:
    """[n] bool, True at ``idx``."""
    return torch.zeros((n,), dtype=torch.bool, device=device).index_fill(
        0, idx, True)


def _detached(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple):
        return tuple(_detached(v) for v in x)
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    return x


def loss_and_grads(fn: Callable, params: Any, inputs: Any,
                   denom: Optional[int] = None):
    """(``fn(params, inputs)`` detached, the grads of the mean of its
    per-example losses as a tree shaped like ``params``; with ``denom``,
    of their sum over ``denom``). ``fn`` returns
    the losses [n], or a tuple led by them whose other entries are
    returned beside them, never differentiated. An empty leaf (a stack
    of no layers, such as a moe model cut to its ``first_k_dense`` layers)
    takes no part in the loss; its grad is an empty tensor."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(live)
    out = fn(tree_map(lambda _, p: next(it), params), inputs)
    pel = out[0] if isinstance(out, tuple) else out
    used = [p for p in live if p.numel()]
    obj = pel.mean() if denom is None else pel.sum() / denom
    grads = iter(torch.autograd.grad(obj, used))
    return _detached(out), tree_map(
        lambda _, p: next(grads) if p.numel() else torch.zeros_like(p),
        params)


def _all_reduce_tree(tree: Any, layout) -> Any:
    """The sum over ranks of every leaf that ``layout`` holds whole (the
    sliced leaves' grads come out of the backward already
    reduce-scattered): one all-reduce a dtype bucket."""
    leaves = tree_leaves(tree)
    whole = [i for i, h in enumerate(layout.held_mask()) if not h]
    out = list(leaves)
    if whole:
        red = compat.all_reduce_buckets([leaves[i] for i in whole])
        for i, x in zip(whole, red):
            out[i] = x
    it = iter(out)
    return tree_map(lambda _, __: next(it), tree)


def make_train_step(
    per_example_loss_fn: Callable[[Any, Batch], torch.Tensor],
    optimizer: Optimizer,
    cfg: OBFTFConfig,
    *,
    mesh=None,
    dp_axes: Sequence[str] = ("data",),
):
    """Build ``train_step(state, batch, noise) -> (state, metrics)``.

    state = {"params": tree, "opt": optimizer state, "step": 0-dim int32};
    batch = {"tokens", "labels"[, "recorded_loss", "instance_id"]}, leaves
    leading with the batch dim; ``noise`` supplies the selection's draws.
    The returned state is new, except the optimizer's moments, which
    ``optimizer.update`` advances in place. Metrics are device tensors:
    those of the JAX step, plus ``selected``, the kept rows' indices.

    With ``mesh`` (a ``launch.mesh.Mesh``; the data axis is ``dp_axes``
    of its shape, S ranks) the step is a collective that every rank calls
    with its segment of the global batch (``n_local`` rows; the global
    batch is ``S * n_local``). ``noise`` is then, under shard-local
    selection, this rank's own draws, the counterpart of JAX's
    ``fold_in(rng_sel, rank)``: the train CLI seeds a ``torch.Generator``
    with ``fold_seed(seed, rank)``, and the parity tests hand rank r
    ``fold_in(split(rng, 3)[1], r)``'s draws. Under global selection
    (``shard_local=False``) every rank must take the same draws (JAX's
    unfolded ``rng_sel``). The metrics are the JAX step's global ones
    (``loss``, ``selected_mean_loss``, ``selection_residual``, ``kept``,
    ``step_cost``, ``grad_norm``, and ``selected``, the global indices of
    every kept row), except ``per_example_loss`` and
    ``per_example_fresh``, which are this rank's segment, what the
    sharded ledger's ops take.

    With a mesh the optimizer must carry this rank's layout
    (``optimizer.layout``, a ``distributed.zero.DataLayout``): the state's
    params are held in it, and the step runs under ``use_rules(mesh,
    layout.rules, layout)``."""
    sel = cfg.selection
    shards = 1 if mesh is None else _dp_shard_count(mesh, dp_axes)
    layout = optimizer.layout
    if mesh is not None and layout is None:
        raise ValueError("make_train_step(mesh=) needs an optimizer built "
                         "with this rank's layout (adamw(layout=), "
                         "distributed.zero.data_layout)")

    def train_step(state: dict, batch: Batch, noise: Noise):
        if mesh is None:
            return _train_step(state, batch, noise)
        with use_rules(mesh, layout.rules, layout):
            return _train_step(state, batch, noise)

    def _train_step(state: dict, batch: Batch, noise: Noise):
        params = state["params"]
        inputs = model_inputs(batch)
        dev = state["step"].device
        n_local = next(iter(inputs.values())).shape[0]
        n = shards * n_local
        global_sel = mesh is not None and not cfg.shard_local
        if global_sel and cfg.mode != "full" and sel.budget(n) % shards:
            raise ValueError(
                f"global selection keeps {sel.budget(n)} rows of {n}, which "
                f"do not divide over {shards} ranks: each rank trains an "
                "equal share of the kept list (use shard_local=True or "
                "another ratio)")
        rank = 0 if mesh is None else compat.linear_axis_index()

        if cfg.mode == "full":
            per_example, grads = loss_and_grads(
                per_example_loss_fn, params, inputs,
                None if mesh is None else n)
            per_example = per_example.to(F32)
            loss = (per_example.mean() if mesh is None else
                    compat.all_reduce_sum(per_example.sum()) / n)
            sel_mean = loss
            residual = _scalar(0.0, dev)
            per_example_fresh = torch.ones((n_local,), dtype=torch.bool,
                                           device=dev)
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
            if not global_sel:
                # 6-7: subset selection over the batch, or this rank's
                # segment of it
                sub_batch, sel_idx, sel_losses = select_and_gather(
                    sel, noise, losses, batch, mesh=mesh)
                b = sel_losses.shape[0] * shards  # the global kept count
                # 8: one backward on the kept subset; its per-example
                # losses fall out of the same forward
                sub_losses, grads = loss_and_grads(
                    per_example_loss_fn, params, model_inputs(sub_batch),
                    None if mesh is None else b)
                sub_losses = sub_losses.to(F32)
                local_idx = sel_idx - rank * n_local
                per_example = losses.index_put((local_idx,), sub_losses)
                trained = _mask(n_local, local_idx, dev)
                if mesh is None:
                    loss = sub_losses.mean()
                    sel_mean = sel_losses.mean()
                    residual = torch.abs(sel_mean - losses.mean())
                else:
                    # the global sums and every rank's picks, one gather
                    # (indices as f32: exact below 2^24 rows)
                    row = torch.cat([torch.stack([
                        sub_losses.sum(), sel_losses.sum(), losses.sum()]),
                        sel_idx.to(F32)])
                    rows = compat.all_gather(row).view(shards, -1)
                    tot = rows[:, :3].sum(0)
                    loss, sel_mean = tot[0] / b, tot[1] / b
                    residual = torch.abs(sel_mean - tot[2] / n)
                    sel_idx = rows[:, 3:].reshape(-1).to(torch.int64)
            else:
                # 6-7 over the global batch, on every rank alike; rank r
                # trains its share of the kept list
                losses_all = compat.all_gather(losses)
                b = sel.budget(n)
                sel_idx = select(sel, noise, losses_all, b)
                share = sel_idx[rank * (b // shards):
                                (rank + 1) * (b // shards)]
                sub_inputs = {k: compat.all_gather(v).index_select(0, share)
                              for k, v in inputs.items()}
                sub_losses, grads = loss_and_grads(
                    per_example_loss_fn, params, sub_inputs, b)
                sub_all = compat.all_gather(sub_losses.to(F32))
                seg = slice(rank * n_local, (rank + 1) * n_local)
                per_example = losses_all.index_put((sel_idx,), sub_all)[seg]
                loss = sub_all.mean()
                sel_mean = losses_all.index_select(0, sel_idx).mean()
                residual = torch.abs(sel_mean - losses_all.mean())
                trained = _mask(n, sel_idx, dev)[seg]
            kept = float(b)
            step_cost = (0.0 if recycled else 1.0) + 3.0 * kept / n
            # recycled, only the kept rows carry a loss computed this step
            per_example_fresh = (trained if recycled else torch.ones(
                (n_local,), dtype=torch.bool, device=dev))

        with torch.no_grad():
            if mesh is not None:
                grads = _all_reduce_tree(grads, layout)
            updates, opt_state = optimizer.update(grads, state["opt"], params)
            del grads
            new_state = {
                "params": apply_updates(params, updates),
                "opt": opt_state,
                "step": state["step"] + 1,
            }
            metrics = {
                "loss": loss,
                "selected_mean_loss": sel_mean,
                "selection_residual": residual,
                "kept": _scalar(kept, dev),
                "step_cost": _scalar(step_cost, dev),
                "grad_norm": global_norm(updates, layout),
                # true per-instance signals aligned to the in-batch index
                # (this rank's segment under a mesh); `fresh` marks entries
                # computed this step
                "per_example_loss": per_example,
                "per_example_fresh": per_example_fresh,
                # the kept rows' global batch positions (not among the JAX
                # step's metrics, which keeps them inside the jit)
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
