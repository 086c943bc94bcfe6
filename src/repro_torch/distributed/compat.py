"""The collectives of the port's data axis, and the version shims for them.

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

The data axis is the default process group (``launch.mesh``). The
collectives are blocking (``async_op=False``). On NCCL, blocking means
the caller's stream waits for the collective's; the host does not, so
they run inside the engine's guarded step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def axis_size() -> int:
    """The data axis's size: the default group's number of ranks."""
    return dist.get_world_size()


def linear_axis_index() -> int:
    """This rank's index on the data axis: the order of its segment in a
    gathered batch (``all_gather``) and of its slice of a sharded table,
    the alignment that ledger routing depends on."""
    return dist.get_rank()


def host_staged() -> bool:
    """Whether the group moves tensors through host memory (gloo)."""
    return dist.get_backend() == "gloo"


def _in(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if x.is_cuda and host_staged() else x


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[b, ...] on every rank -> [S*b, ...]: rank r's rows at [r*b, (r+1)*b)
    (JAX's ``all_gather(..., tiled=True)``)."""
    src = _in(x)
    out = src.new_empty((axis_size() * src.shape[0],) + src.shape[1:])
    _all_gather_single(out, src)
    return out.to(x.device)


def all_to_all(x: torch.Tensor, send: Optional[list[int]] = None,
               recv: Optional[list[int]] = None) -> torch.Tensor:
    """[S*c, ...] -> [S*c, ...]: rows [j*c, (j+1)*c) go to rank j, and rank
    i's rows land at [i*c, (i+1)*c) (JAX's tiled ``all_to_all`` over the
    leading axis). With ``send`` and ``recv`` (rows to and from each rank)
    the splits are uneven: ``send[j]`` rows go to rank j in order, and
    rank i's ``recv[i]`` rows land in rank order."""
    src = _in(x)
    if send is None:
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
    else:
        out = src.new_empty((sum(recv),) + src.shape[1:])
        dist.all_to_all_single(out, src, list(recv), list(send))
    return out.to(x.device)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, as a new tensor (JAX's ``psum``)."""
    out = _in(x).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(x.device)


def _buckets(xs) -> dict:
    """Leaf positions grouped by dtype, in first-seen order."""
    out: dict = {}
    for i, x in enumerate(xs):
        out.setdefault(x.dtype, []).append(i)
    return out


def all_reduce_buckets(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum over ranks of every tensor of ``xs`` -> new tensors (views
    of one flat buffer a dtype): one ``all_reduce`` a dtype bucket."""
    out: list = [None] * len(xs)
    for idx in _buckets(xs).values():
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        src = _in(flat)  # a fresh buffer: reduced in place
        dist.all_reduce(src, op=dist.ReduceOp.SUM)
        total = src.to(flat.device)
        off = 0
        for i in idx:
            n = xs[i].numel()
            out[i] = total[off:off + n].view(xs[i].shape)
            off += n
    return out


def all_gather_along(xs: list[torch.Tensor],
                     dims: list[int]) -> list[torch.Tensor]:
    """Every rank's piece of each tensor, joined along its dim ``dims[i]``
    in rank order (JAX's ``all_gather(..., axis=d, tiled=True)``) -> full
    tensors: one ``all_gather`` a dtype bucket. Each rank's pieces must
    have the same shapes."""
    out: list = [None] * len(xs)
    size = axis_size()
    for idx in _buckets(xs).values():
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        g = all_gather(flat).view(size, flat.numel())
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


def reduce_scatter_along(xs: list[torch.Tensor],
                         dims: list[int]) -> list[torch.Tensor]:
    """The sum over ranks of each tensor of ``xs``, of which this rank keeps
    its piece along ``dims[i]`` (rank r: indices ``[r*n, (r+1)*n)``, n the
    dim over S): the transpose of ``all_gather_along`` (JAX's
    ``psum_scatter(..., scatter_dimension=d, tiled=True)``). One
    ``reduce_scatter_tensor`` a dtype bucket."""
    out: list = [None] * len(xs)
    size = axis_size()
    for idx in _buckets(xs).values():
        # row j of each part: rank j's piece, flattened in its own order
        parts = [xs[i].unflatten(dims[i], (size, -1)).movedim(dims[i], 0)
                 .reshape(size, -1) for i in idx]
        flat = torch.cat(parts, 1)
        src = _in(flat.reshape(-1))
        red = src.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(red, src)
        red = red.to(flat.device)
        off = 0
        for i, part in zip(idx, parts):
            shape = list(xs[i].shape)
            shape[dims[i]] //= size
            n = part.shape[1]
            out[i] = red[off:off + n].view(shape)
            off += n
    return out


def ring_shift(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """One hop of the ring: each tensor of ``xs`` goes to rank r+1 and rank
    r-1's comes back (JAX's ``ppermute`` with ``(j, j+1 mod S)``), in one
    ``batch_isend_irecv``, waited for."""
    size, rank = axis_size(), linear_axis_index()
    srcs = [_in(x) for x in xs]
    outs = [torch.empty_like(s) for s in srcs]
    ops = ([dist.P2POp(dist.isend, s, (rank + 1) % size, tag=t)
            for t, s in enumerate(srcs)]
           + [dist.P2POp(dist.irecv, o, (rank - 1) % size, tag=t)
              for t, o in enumerate(outs)])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(x.device) for o, x in zip(outs, xs)]


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank (a max-reduce; a collective, and
    a host read: call it outside a guarded step). ``device`` is where the
    group takes its tensors (the rank's card under NCCL)."""
    x = torch.full((1,), int(flag), dtype=torch.int32, device=device)
    src = _in(x)
    dist.all_reduce(src, op=dist.ReduceOp.MAX)
    return bool(src.item())
