"""The (data, model) mesh as ``torch.distributed`` process groups.

The port's counterpart of ``repro.launch.mesh``: one process (rank) per
device, so the JAX package's ``shard_map`` over an axis, and the
collectives GSPMD inserts for a sharded param, become collectives over
that axis's group (``distributed.compat``). The world comes from the
``torchrun`` environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``); without one it is a group of one, set
up in-process. A caller that set up the default group itself (the tests'
``FileStore`` rendezvous) gets a mesh over it.

``make_elastic_mesh(model_parallel)`` picks the model axis as JAX's does:
M given, or for 0 the largest power of two at most min(16, N) that
divides the N ranks; the data axis takes the rest, D = N / M. Rank r sits
at data ``r // M``, model ``r % M``, as JAX reshapes its device list to
(N / M, M), so the ranks of one model group are consecutive (on a node of
several cards they share the fast links). Every rank builds one group for
each data column and each model row, in the same order; an axis that
spans every rank is the default group, and an axis of one rank has no
group and issues no collective.
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
MAX_MODEL = 16  # JAX's cap on the model axis it picks


@dataclasses.dataclass
class Mesh:
    """The (data, model) mesh of one rank: this rank's place on each axis
    (``compat.axis``), its device and the groups' backend."""

    device: torch.device
    backend: str
    owns_group: bool  # this mesh set the default group up; ``close`` ends it
    groups: list = dataclasses.field(default_factory=list)  # made here

    @property
    def rank(self) -> int:
        """This rank in the world."""
        return dist.get_rank()

    @property
    def size(self) -> int:
        """Ranks in the world: data x model."""
        return dist.get_world_size()

    @property
    def data_index(self) -> int:
        return compat.linear_axis_index(compat.DATA)

    @property
    def model_index(self) -> int:
        return compat.linear_axis_index(compat.MODEL)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": compat.axis_size(compat.DATA),
                "model": compat.axis_size(compat.MODEL)}

    def close(self) -> None:
        """Forget the axes, end the groups this mesh made, and the default
        group if this mesh set it up."""
        compat.set_axes(None)
        if dist.is_initialized():
            for g in self.groups:
                dist.destroy_process_group(g)
            if self.owns_group:
                dist.destroy_process_group()
        self.groups = []
        self.owns_group = False


def world_size() -> int:
    """Ranks in the job: the default group's, else ``WORLD_SIZE`` (1
    outside ``torchrun``)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def model_degree(n: int, model_parallel: int = 0) -> int:
    """The model axis on ``n`` ranks (JAX ``make_elastic_mesh``'s pick):
    ``model_parallel``, or for 0 the largest power of two at most
    min(16, n) dividing n. Raises, with JAX's message, where it does not
    divide n."""
    mp = model_parallel
    if mp <= 0:
        mp = 1
        while mp * 2 <= min(MAX_MODEL, n) and n % (mp * 2) == 0:
            mp *= 2
    if n % mp:
        raise ValueError(f"{n} devices not divisible by TP={mp}")
    return mp


def _axes(n: int, mp: int, backend: str, timeout) -> tuple[dict, list]:
    """This rank's two axes on the (n / mp, mp) mesh and the groups made
    for them. Every rank makes every group, in the same order."""
    rank = dist.get_rank()
    data, model = divmod(rank, mp)
    rows = [tuple(d * mp + m for m in range(mp)) for d in range(n // mp)]
    cols = [tuple(d * mp + m for d in range(n // mp)) for m in range(mp)]
    kw = {} if timeout is None else {"timeout": timeout}
    made: list = []

    def group_of(ranks_list, mine):
        if len(ranks_list[0]) == 1:
            return None  # an axis of one: no group, no collective
        if len(ranks_list[0]) == n:
            return None  # every rank: the default group
        out = None
        for ranks in ranks_list:
            g = dist.new_group(list(ranks), backend=backend, **kw)
            made.append(g)
            if ranks == mine:
                out = g
        return out

    model_group = group_of(rows, rows[data])
    data_group = group_of(cols, cols[model])
    return {compat.MODEL: compat.Axis(model_group, rows[data], model),
            compat.DATA: compat.Axis(data_group, cols[model], data)}, made


def make_elastic_mesh(
    model_parallel: int = 0,
    *,
    device: torch.device | str = "cuda",
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
) -> Mesh:
    """The (data, model) mesh of this rank, ``model_parallel`` picked as
    ``model_degree`` picks it (1: every rank on the data axis).

    ``device`` "cuda" without an index takes ``cuda:LOCAL_RANK`` (one rank a
    device); "cpu" keeps the ranks on the CPU. ``backend`` defaults to
    ``BACKENDS``: NCCL for CUDA devices, gloo for the CPU. Where the default
    group is already up, the mesh joins it and takes its backend (an
    explicit ``backend`` must agree). ``timeout`` bounds every collective of
    a group this call sets up (torch's default when None). A model axis
    that does not divide the world raises before any group is set up.
    """
    n = world_size()
    mp = model_degree(n, model_parallel)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if not owns:
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the default group runs {have}, not {backend}")
        backend = have
    else:
        backend = backend or BACKENDS[dev.type]
        kw = {} if timeout is None else {"timeout": timeout}
        if "WORLD_SIZE" in os.environ:  # torchrun
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    axes, made = _axes(n, mp, backend, timeout)
    compat.set_axes(axes)
    return Mesh(dev, backend, owns_group=owns, groups=made)


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
