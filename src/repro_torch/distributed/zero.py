"""The data axis's placement of the params (FSDP) and the optimizer moments
(ZeRO-1).

The port's counterpart of ``repro.distributed.zero``, and of the layout the
JAX trainer's ``state_specs`` gives the train state on a mesh.
``zero1_partition_specs`` is the JAX function: every moment leaf whose
param spec leaves a dim free of the data axis gets its largest such
divisible dim sharded over ``data`` (a leaf whose spec already names
``data``, such as an FSDP'd ``embed`` dim, keeps that placement).

JAX realizes that layout through GSPMD propagation. Here it is explicit
(``DataLayout``, one object for the params and the moments): one cut dim a
leaf, rank r holding indices ``[r*n, (r+1)*n)`` of it, n = dim / S.

* A leaf whose PARAM spec names ``data`` (``spec_for``, the divisibility
  filter included: the FSDP'd ``embed`` dim, ``expert_mlp`` for the
  experts) is held as this rank's slice, param and moments alike, as the
  JAX trainer shards it. Each layer gathers its slices when it runs and
  the backward reduce-scatters their grads (``distributed.sharding``'s
  ``param_gather_constraint``, ZeRO-3), so the update is computed and
  applied on the slice and never gathered.
* A leaf whose param spec has no ``data`` (mamba2-370m's ``conv_w``,
  ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip`` and the SSM ``norm``) is
  held whole on every rank, its grads all-reduced; its moments keep their
  ZeRO-1 slice, and one ``all_gather`` a dtype bucket
  (``compat.all_gather_along``) rebuilds its full update on every rank.

So every rank holds a 1/S of each sliced leaf and the whole of the
others, as JAX's devices do. A data axis of one holds every leaf whole.
The layout also carries the rule table it was cut with, which the train
step runs under (``sharding.use_rules``): the one owner of both is the
optimizer built with it (``optim.adamw(layout=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed import compat
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    AxisRules,
    PartitionSpec,
    axis_names,
    spec_for,
)
from repro_torch.models.params import (
    ParamSpec,
    tree_at,
    tree_leaves,
    tree_map,
)


def _zero1_spec(spec: ParamSpec, pspec: PartitionSpec, mesh,
                data_axis: str) -> PartitionSpec:
    """Add ``data_axis`` to the largest unsharded, divisible dim of the
    param."""
    parts = list(pspec) + [None] * (len(spec.shape) - len(pspec))
    if any(data_axis in axis_names(p) for p in parts):
        return pspec  # already data-sharded (e.g. FSDP'd embed dim)
    size = mesh.shape[data_axis]
    best, best_dim = -1, -1
    for i, (dim, part) in enumerate(zip(spec.shape, parts)):
        if part is None and dim % size == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim < 0:
        return pspec
    parts[best_dim] = data_axis
    return tuple(parts)


def zero1_partition_specs(
    specs: Any, rules: AxisRules, mesh, data_axis: Optional[str] = None,
) -> Any:
    """Moment-tensor partition specs: param specs + data-axis sharding."""
    data_axis = data_axis or rules.batch_axes[-1]

    def leaf(_, s: ParamSpec) -> PartitionSpec:
        return _zero1_spec(s, spec_for(s, rules, mesh), mesh, data_axis)

    return tree_map(leaf, specs)


DATA_AXIS = "data"  # the mesh axis the port places params and moments on

# which leaves a layout's ``slice`` and ``gather`` act on: every cut leaf
# (full trees <-> moment slices), the leaves whose params are held sliced
# (full params <-> the params as a rank holds them), or the cut leaves
# whose params are held whole (held params, grads or updates <-> moment
# slices)
ALL, HELD, REPLICATED = "all", "held", "replicated"


@dataclasses.dataclass(frozen=True)
class DataLayout:
    """Which slice of each param and moment leaf this rank keeps.

    ``dims`` is a tree shaped like the params: the dim cut over the data
    axis (the moments' cut, and the param's where ``held``), or None where
    the leaf stays whole. ``held`` says, a leaf, whether the param itself
    is held as this rank's slice of that dim (its param spec names the
    data axis: FSDP) or whole. ``shapes`` are the full leaves' shapes.
    ``shards`` ranks on the data axis; this is rank ``rank``. ``rules``
    is the table the layout was cut with, and the one the train step
    runs under."""

    dims: Any
    held: Any
    shapes: Any
    shards: int
    rank: int
    rules: AxisRules = DEFAULT_RULES

    def piece(self, x: Any, dim: Optional[int]) -> Any:
        """This rank's slice of a full leaf (a tensor or a numpy array) cut
        along ``dim`` (a view; the leaf itself on a data axis of one)."""
        if dim is None or self.shards == 1:
            return x
        n = x.shape[dim] // self.shards
        lo = self.rank * n
        return x[(slice(None),) * dim + (slice(lo, lo + n),)]

    def dim_at(self, path: tuple) -> Optional[int]:
        """The dim cut at a params path (None: the leaf stays whole)."""
        return tree_at(self.dims, path)

    def held_at(self, path: tuple) -> bool:
        """Whether the param at ``path`` is held as this rank's slice."""
        return tree_at(self.held, path)

    def shape_at(self, path: tuple) -> tuple:
        """The full shape of the leaf at ``path``."""
        return tree_at(self.shapes, path)

    def held_mask(self) -> list[bool]:
        """A bool a leaf, in ``tree_leaves`` order: held sliced."""
        return tree_leaves(self.held)

    def _chosen(self, which: str) -> list[Optional[int]]:
        """The cut dim of each leaf that ``which`` picks, else None."""
        pick = {ALL: lambda h: True, HELD: lambda h: h,
                REPLICATED: lambda h: not h}[which]
        return [d if d is not None and pick(h) else None
                for d, h in zip(tree_leaves(self.dims), self.held_mask())]

    def slice(self, tree: Any, which: str = ALL) -> Any:
        """This rank's slices of the leaves of a params-shaped tree that
        ``which`` picks (views); the others as they are. ``ALL``: full ->
        moment slices; ``HELD``: full params -> the params as this rank
        holds them; ``REPLICATED``: held params (or grads) -> moment
        slices."""
        dims = iter(self._chosen(which))
        return tree_map(lambda _, x: self.piece(x, next(dims)), tree)

    def gather(self, pieces: Any, which: str = ALL) -> Any:
        """Full leaves from every rank's slices of the leaves that ``which``
        picks (the inverse of ``slice``): one ``all_gather`` a dtype bucket
        (a collective: every rank calls it). The other leaves come back as
        they are; a data axis of one moves nothing."""
        leaves, dims = tree_leaves(pieces), self._chosen(which)
        cut = [i for i, d in enumerate(dims) if d is not None]
        if self.shards > 1 and cut:
            full = compat.all_gather_along([leaves[i] for i in cut],
                                           [dims[i] for i in cut])
            leaves = list(leaves)
            for i, x in zip(cut, full):
                leaves[i] = x
        it = iter(leaves)
        return tree_map(lambda _, __: next(it), pieces)

    def hold(self, params: Any) -> Any:
        """The params as this rank holds them, from the full tree: copies of
        its slices of the held leaves (so the full tree can be freed), the
        other leaves as they are; on a data axis of one, the tree."""
        if self.shards == 1:
            return params
        dims = iter(self._chosen(HELD))

        def leaf(_, x):
            d = next(dims)
            if d is None:
                return x
            return self.piece(x, d).clone(
                memory_format=torch.contiguous_format)

        return tree_map(leaf, params)


def data_layout(specs: Any, mesh, rank: int,
                rules: AxisRules = DEFAULT_RULES) -> DataLayout:
    """The layout of rank ``rank`` on ``mesh`` (anything with a ``shape``
    dict), from the param specs' JAX param and moment specs under
    ``rules``, over the port's one data axis, ``data`` (``FSDP_RULES``
    name it beside ``model``, whose size is 1 here)."""
    parts = zero1_partition_specs(specs, rules, mesh, DATA_AXIS)

    def dim(_, p: PartitionSpec) -> Optional[int]:
        hits = [i for i, a in enumerate(p) if DATA_AXIS in axis_names(a)]
        return hits[0] if hits else None

    def held(_, s: ParamSpec) -> bool:
        return any(DATA_AXIS in axis_names(a)
                   for a in spec_for(s, rules, mesh))

    # a partition spec is a tuple, which tree_map takes as a leaf
    return DataLayout(tree_map(dim, parts), tree_map(held, specs),
                      tree_map(lambda _, s: tuple(s.shape), specs),
                      mesh.shape[DATA_AXIS], rank, rules)
