"""The collectives of the port's mesh axes, and the version shims for them.

The port's counterpart of ``repro.distributed.compat``. The JAX package
runs its sharded ops inside ``shard_map`` over the mesh's data axes; the
port runs one process (rank) per device, and the data axis is a
``torch.distributed`` process group. Every collective in the port goes
through this module, so one place decides how a group moves tensors:

* ``torch.distributed.all_gather_single`` replaces
  ``all_gather_into_tensor`` in newer torch (which deprecates the old
  name); older torch has only the latter. The shim takes whichever the
  running torch has.
* A gloo group moves tensors through host memory. Where its tables live
  on a card (several ranks sharing one GPU, which NCCL refuses), a CUDA
  tensor is staged through the CPU on the way in and out. The group's
  backend decides this, never a caught error.

The data-parallel train step moves whole trees: ``all_reduce_buckets``
(the gradients of the params held whole), ``all_gather_along`` (a layer's
param slices, FSDP's gather, and the ZeRO-1 update slices) and its
transpose ``reduce_scatter_along`` (the gathered params' gradients, summed
and cut back to each rank's slices) pack every leaf of one dtype into one
flat bucket, so each makes one collective a dtype, not one a leaf.
``ring_shift`` is one hop of a ring (JAX's ``ppermute`` to rank r+1), the
int8 all-reduce's (``distributed.compression``); ``all_to_all`` takes
uneven splits for the int8 gather's re-layout. ``any_rank`` max-reduces a
host flag (the trainer's agreed stop).

gloo has ``reduce_scatter_tensor`` (bf16 included), the point-to-point ops
of ``batch_isend_irecv`` and uneven ``all_to_all_single`` in the torch of
the CPU tests (2.13) and of the card's machine (2.11), so every backend
takes the same calls.

Every collective takes the mesh axis it runs over, ``"data"`` (the
default) or ``"model"``. ``launch.mesh`` registers each axis's group
(``set_axes``): a ``torch.distributed`` group of this rank's data column or
model row, the default group where the axis spans every rank. Without a
registered mesh the data axis is the default group and the model axis a
group of one. An axis of one rank issues no collective: each call returns
its input (a copy where the call returns a new tensor). An axis given a
group of its own (``Axis.group`` set, which ``launch.mesh`` never does for
an axis of one) always issues its collective, ``ring_shift`` aside (a
ring of one has no hop), so a group of one NCCL rank can still drive this
module's NCCL route on a card. ``any_rank``
alone is world-wide, since a stop must reach every rank. A group moves
tensors through the host where its own backend is gloo. The
collectives are blocking (``async_op=False``). On NCCL, blocking means
the caller's stream waits for the collective's; the host does not, so
they run inside the engine's guarded step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


DATA, MODEL = "data", "model"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis of this rank: its group (None: the default group),
    the global ranks in it in axis order, and this rank's index there."""

    group: Optional[dist.ProcessGroup]
    ranks: tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def solo(self) -> bool:
        """One rank and no group of its own: nothing to move."""
        return self.size == 1 and self.group is None


_axes: dict[str, Axis] = {}


def set_axes(axes: Optional[dict[str, Axis]]) -> None:
    """Register the mesh's axes (``launch.mesh``); None forgets them."""
    _axes.clear()
    _axes.update(axes or {})


def axis(name: str = DATA) -> Axis:
    """The registered axis ``name``; without a mesh, the data axis is the
    default group and the model axis this rank alone."""
    if name in _axes:
        return _axes[name]
    if name == DATA:
        n = dist.get_world_size()
        return Axis(None, tuple(range(n)), dist.get_rank())
    if name == MODEL:
        return Axis(None, (0,), 0)
    raise ValueError(f"no mesh axis {name!r}")


def axis_size(name: str = DATA) -> int:
    """The number of ranks on the axis."""
    return axis(name).size


def expect(name: str, size: int, index: int) -> None:
    """Raise unless the registered axis ``name`` has ``size`` ranks and
    this rank at ``index``: a layout cut for one mesh, gathered or summed
    over the axes of another (or of none, after ``set_axes(None)``), would
    move the wrong pieces without a word."""
    ax = axis(name)
    if (ax.size, ax.index) != (size, index):
        raise RuntimeError(
            f"the {name} axis registered here is rank {ax.index} of "
            f"{ax.size}, the layout's rank {index} of {size}: run it under "
            "the mesh it was cut for (launch.mesh registers its axes until "
            "close)")


def linear_axis_index(name: str = DATA) -> int:
    """This rank's index on the axis: on the data axis, the order of its
    segment in a gathered batch (``all_gather``) and of its slice of a
    sharded table, the alignment that ledger routing depends on."""
    return axis(name).index


def host_staged(name: str = DATA) -> bool:
    """Whether the axis's group moves tensors through host memory (gloo)."""
    return dist.get_backend(axis(name).group) == "gloo"


def _in(x: torch.Tensor, name: str) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if x.is_cuda and host_staged(name) else x


def all_gather(x: torch.Tensor, name: str = DATA) -> torch.Tensor:
    """[b, ...] on every rank -> [S*b, ...]: rank r's rows at [r*b, (r+1)*b)
    (JAX's ``all_gather(..., tiled=True)``)."""
    ax = axis(name)
    if ax.solo:
        return x.clone()
    src = _in(x, name)
    out = src.new_empty((ax.size * src.shape[0],) + src.shape[1:])
    _all_gather_single(out, src, group=ax.group)
    return out.to(x.device)


def all_to_all(x: torch.Tensor, send: Optional[list[int]] = None,
               recv: Optional[list[int]] = None,
               name: str = DATA) -> torch.Tensor:
    """[S*c, ...] -> [S*c, ...]: rows [j*c, (j+1)*c) go to rank j, and rank
    i's rows land at [i*c, (i+1)*c) (JAX's tiled ``all_to_all`` over the
    leading axis). With ``send`` and ``recv`` (rows to and from each rank)
    the splits are uneven: ``send[j]`` rows go to rank j in order, and
    rank i's ``recv[i]`` rows land in rank order."""
    ax = axis(name)
    if ax.solo:
        return x.clone()
    src = _in(x, name)
    if send is None:
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=ax.group)
    else:
        out = src.new_empty((sum(recv),) + src.shape[1:])
        dist.all_to_all_single(out, src, list(recv), list(send),
                               group=ax.group)
    return out.to(x.device)


def _sum_(buf: torch.Tensor, name: str) -> torch.Tensor:
    """The sum over the axis of ``buf``, reduced in place where the group
    takes it as it is (a fresh buffer: the caller's own)."""
    ax = axis(name)
    if ax.solo:
        return buf
    src = _in(buf, name)
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=ax.group)
    return src.to(buf.device)


def all_reduce_sum(x: torch.Tensor, name: str = DATA) -> torch.Tensor:
    """The sum over the axis's ranks, as a new tensor (JAX's ``psum``)."""
    return _sum_(x.contiguous().clone(), name)


def _buckets(xs) -> dict:
    """Leaf positions grouped by dtype, in first-seen order."""
    out: dict = {}
    for i, x in enumerate(xs):
        out.setdefault(x.dtype, []).append(i)
    return out


def all_reduce_buckets(xs: list[torch.Tensor],
                       name: str = DATA) -> list[torch.Tensor]:
    """The sum over the axis's ranks of every tensor of ``xs`` -> new
    tensors (views of one flat buffer a dtype): one ``all_reduce`` a dtype
    bucket."""
    out: list = [None] * len(xs)
    for idx in _buckets(xs).values():
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        total = _sum_(flat, name)
        off = 0
        for i in idx:
            n = xs[i].numel()
            out[i] = total[off:off + n].view(xs[i].shape)
            off += n
    return out


def all_gather_along(xs: list[torch.Tensor], dims: list[int],
                     name: str = DATA) -> list[torch.Tensor]:
    """Every rank's piece of each tensor, joined along its dim ``dims[i]``
    in rank order (JAX's ``all_gather(..., axis=d, tiled=True)``) -> full
    tensors: one ``all_gather`` a dtype bucket. Each rank's pieces must
    have the same shapes."""
    out: list = [None] * len(xs)
    size = axis_size(name)
    for idx in _buckets(xs).values():
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        g = all_gather(flat, name).view(size, flat.numel())
        off = 0
        for i in idx:
            x, d = xs[i], dims[i]
            n = x.numel()
            stacked = g[:, off:off + n].reshape((size,) + x.shape)
            full = list(x.shape)
            full[d] *= size
            out[i] = stacked.movedim(0, d).reshape(full)
            off += n
    return out


def reduce_scatter_along(xs: list[torch.Tensor], dims: list[int],
                         name: str = DATA) -> list[torch.Tensor]:
    """The sum over ranks of each tensor of ``xs``, of which this rank keeps
    its piece along ``dims[i]`` (rank r: indices ``[r*n, (r+1)*n)``, n the
    dim over S): the transpose of ``all_gather_along`` (JAX's
    ``psum_scatter(..., scatter_dimension=d, tiled=True)``). One
    ``reduce_scatter_tensor`` a dtype bucket."""
    out: list = [None] * len(xs)
    ax = axis(name)
    size = ax.size
    for idx in _buckets(xs).values():
        # row j of each part: rank j's piece, flattened in its own order
        parts = [xs[i].unflatten(dims[i], (size, -1)).movedim(dims[i], 0)
                 .reshape(size, -1) for i in idx]
        flat = torch.cat(parts, 1)
        if ax.solo:
            red = flat.reshape(-1).clone()
        else:
            src = _in(flat.reshape(-1), name)
            red = src.new_empty(flat.shape[1])
            dist.reduce_scatter_tensor(red, src, group=ax.group)
            red = red.to(flat.device)
        off = 0
        for i, part in zip(idx, parts):
            shape = list(xs[i].shape)
            shape[dims[i]] //= size
            n = part.shape[1]
            out[i] = red[off:off + n].view(shape)
            off += n
    return out


def ring_shift(xs: list[torch.Tensor],
               name: str = DATA) -> list[torch.Tensor]:
    """One hop of the ring: each tensor of ``xs`` goes to rank r+1 of the
    axis and rank r-1's comes back (JAX's ``ppermute`` with ``(j, j+1 mod
    S)``), in one ``batch_isend_irecv``, waited for."""
    ax = axis(name)
    size, rank = ax.size, ax.index
    if size == 1:  # a ring of one: no hop, whatever the group
        return [x.clone() for x in xs]
    nxt, prv = ax.ranks[(rank + 1) % size], ax.ranks[(rank - 1) % size]
    srcs = [_in(x, name) for x in xs]
    outs = [torch.empty_like(s) for s in srcs]
    ops = ([dist.P2POp(dist.isend, s, nxt, ax.group, tag=t)
            for t, s in enumerate(srcs)]
           + [dist.P2POp(dist.irecv, o, prv, ax.group, tag=t)
              for t, o in enumerate(outs)])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(x.device) for o, x in zip(outs, xs)]


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank of the world, every axis (a
    max-reduce over the default group; a collective, and a host read:
    call it outside a guarded step). ``device`` is where the group takes
    its tensors (the rank's card under NCCL)."""
    x = torch.full((1,), int(flag), dtype=torch.int32, device=device)
    src = x.cpu() if x.is_cuda and dist.get_backend() == "gloo" else x
    dist.all_reduce(src, op=dist.ReduceOp.MAX)
    return bool(src.item())
