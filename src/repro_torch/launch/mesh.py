"""The data axis of the mesh as a ``torch.distributed`` process group.

The port's counterpart of ``repro.launch.mesh``, for the data axis only:
one process (rank) per device, so the JAX package's ``shard_map`` over
``data`` becomes collectives over the group (``distributed.compat``).
The world comes from the ``torchrun`` environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); without one it
is a group of one, set up in-process. A caller that set up the default
group itself (the tests' ``FileStore`` rendezvous) gets a mesh over it.

The model axis (tensor, expert and sequence parallelism) is not ported:
``model_parallel > 1`` raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed import compat

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}  # the default for each device


@dataclasses.dataclass
class Mesh:
    """The (data, model) mesh of one rank: the default process group as the
    data axis, this rank's device, and the group's backend. ``model`` is 1."""

    device: torch.device
    backend: str
    owns_group: bool  # this mesh set the group up, and ``close`` ends it

    @property
    def rank(self) -> int:
        return compat.linear_axis_index()

    @property
    def size(self) -> int:
        return compat.axis_size()

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size, "model": 1}

    def close(self) -> None:
        """End the process group if this mesh set it up."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def world_size() -> int:
    """Ranks in the job: the default group's, else ``WORLD_SIZE`` (1
    outside ``torchrun``)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_elastic_mesh(
    model_parallel: int = 0,
    *,
    device: torch.device | str = "cuda",
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
) -> Mesh:
    """The data-axis mesh of this rank.

    ``device`` "cuda" without an index takes ``cuda:LOCAL_RANK`` (one rank a
    device); "cpu" keeps the ranks on the CPU. ``backend`` defaults to
    ``BACKENDS``: NCCL for CUDA devices, gloo for the CPU. Where the default
    group is already up, the mesh joins it and takes its backend (an
    explicit ``backend`` must agree). ``timeout`` bounds every collective of
    a group this call sets up (torch's default when None).
    """
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1 is not ported: the port's mesh has the data "
            "axis only (ROADMAP Queue 1 item 2, model parallelism)"
        )
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the default group runs {have}, not {backend}")
        return Mesh(dev, have, owns_group=False)
    backend = backend or BACKENDS[dev.type]
    kw = {} if timeout is None else {"timeout": timeout}
    if "WORLD_SIZE" in os.environ:  # torchrun
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return Mesh(dev, backend, owns_group=True)


def validate_batch(
    global_batch: int, mesh: Mesh, batch_axes: Sequence[str] = ("data",)
) -> int:
    """The per-rank batch; raises unless the global batch divides evenly."""
    shards = math.prod(mesh.shape[a] for a in batch_axes)
    if global_batch % shards:
        raise ValueError(
            f"global batch {global_batch} not divisible by {shards} data "
            f"shards (mesh {mesh.shape}); adjust batch or mesh"
        )
    return global_batch // shards
