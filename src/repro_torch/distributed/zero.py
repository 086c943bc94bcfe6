"""ZeRO-1: the optimizer moments sharded over the data axis.

The port's counterpart of ``repro.distributed.zero``. ``zero1_partition_specs``
is the JAX function: every moment leaf whose param spec leaves a dim free of
the data axis gets its largest such divisible dim sharded over ``data``
(a leaf whose spec already names ``data``, such as an FSDP'd ``embed`` dim,
keeps that placement).

JAX realizes that layout through GSPMD propagation. Here it is explicit
(``Zero1Layout``): each rank keeps, of each AdamW moment leaf, only its
slice along the dim that the JAX moment spec gives the data axis (rank r
holds indices ``[r*n, (r+1)*n)`` of that dim, n = dim / S); a leaf with no
such dim stays whole on every rank. The optimizer computes the update on
the slice (grad slice, param slice, moment slice), and one ``all_gather``
a dtype bucket (``compat.all_gather_along``) rebuilds the full update on
every rank.

One placement differs from the JAX package's: the parameters stay
replicated on every rank (JAX's ``state_specs`` FSDP-shards them over
``data`` on their ``embed`` dim). That costs memory, not values: the
update each rank applies is the same full update. FSDP placement of the
parameters comes with the model axis (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.distributed import compat
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    AxisRules,
    PartitionSpec,
    axis_names,
    spec_for,
)
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map


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


@dataclasses.dataclass(frozen=True)
class Zero1Layout:
    """Which slice of each moment leaf this rank keeps.

    ``dims`` is a tree shaped like the params: the dim cut over the data
    axis, or None where the leaf stays whole. ``shards`` ranks on the data
    axis; this is rank ``rank``."""

    dims: Any
    shards: int
    rank: int

    def piece(self, x: Any, dim: Optional[int]) -> Any:
        """This rank's slice of a full leaf (a tensor or a numpy array) cut
        along ``dim`` (a view)."""
        if dim is None:
            return x
        n = x.shape[dim] // self.shards
        lo = self.rank * n
        return x[(slice(None),) * dim + (slice(lo, lo + n),)]

    def dim_at(self, path: tuple) -> Optional[int]:
        """The dim cut at a params path (None: the leaf stays whole)."""
        node = self.dims
        for k in path:
            node = node[k]
        return node

    def slice(self, tree: Any) -> Any:
        """This rank's slices of a params-shaped tree (views)."""
        dims = iter(tree_leaves(self.dims))
        return tree_map(lambda _, x: self.piece(x, next(dims)), tree)

    def gather(self, pieces: Any) -> Any:
        """Full leaves from every rank's slices: one ``all_gather`` a dtype
        bucket (a collective: every rank calls it). Whole leaves come back
        as they are; a data axis of one moves nothing."""
        leaves, dims = tree_leaves(pieces), tree_leaves(self.dims)
        cut = [i for i, d in enumerate(dims) if d is not None]
        if self.shards > 1 and cut:
            full = compat.all_gather_along([leaves[i] for i in cut],
                                           [dims[i] for i in cut])
            leaves = list(leaves)
            for i, x in zip(cut, full):
                leaves[i] = x
        it = iter(leaves)
        return tree_map(lambda _, __: next(it), pieces)


def zero1_layout(specs: Any, mesh, rank: int,
                 rules: AxisRules = DEFAULT_RULES) -> Zero1Layout:
    """The ZeRO-1 layout of rank ``rank`` on ``mesh`` (anything with a
    ``shape`` dict), from the param specs' JAX moment specs."""
    data_axis = rules.batch_axes[-1]
    parts = zero1_partition_specs(specs, rules, mesh, data_axis)

    def dim(_, p: PartitionSpec) -> Optional[int]:
        hits = [i for i, a in enumerate(p) if data_axis in axis_names(a)]
        return hits[0] if hits else None

    # a partition spec is a tuple, which tree_map takes as a leaf
    return Zero1Layout(tree_map(dim, parts), mesh.shape[data_axis], rank)
