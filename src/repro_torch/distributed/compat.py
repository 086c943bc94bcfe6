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

The data axis is the default process group (``launch.mesh``). The
collectives are blocking (``async_op=False``). On NCCL, blocking means
the caller's stream waits for the collective's; the host does not, so
they run inside the engine's guarded step.
"""

from __future__ import annotations

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


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """[S*c, ...] -> [S*c, ...]: rows [j*c, (j+1)*c) go to rank j, and rank
    i's rows land at [i*c, (i+1)*c) (JAX's tiled ``all_to_all`` over the
    leading axis)."""
    src = _in(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src)
    return out.to(x.device)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, as a new tensor (JAX's ``psum``)."""
    out = _in(x).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(x.device)
