"""Wrapper of the CUDA recycle-ledger transaction (``csrc/ledger.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.ledger.ledger_record_priority``
in both of its variants with one launch: the table is cut into tiles
(``tile_plan``), and the block that owns a tile walks the batch, resolves
its tile's writes in shared memory, copies the tile and scores the tile's
items. The source's header says what bounds it on the H100; its plain
version is ``kernels.ref.ledger_record_priority_ref``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

VARIANTS = ("fori", "block")

# mirror csrc/ledger.cu: the header of a block's shared memory (ints), and
# the shared memory one block may use on sm_90
HEADER_INTS = 4
MAX_SMEM = 232448
# the tile plan: slots a tile at small batches (64 tiles at capacity 65536,
# 256 at 2^18); at most WALK_ITEMS ids read from L2 over all blocks, so a
# large batch takes fewer, larger tiles; at most MAX_TILE_SLOTS slots a
# tile (the tile and its winners, 80 KB of shared memory); an item list of
# twice a tile's expected share of the batch within [MIN_ROOM, MAX_ROOM] (a
# tile that gets more walks the batch again)
TILE_SLOTS = 1024
WALK_ITEMS = 1 << 22
MAX_TILE_SLOTS = 1 << 12
MIN_ROOM, MAX_ROOM = 256, 4096


def resolve_variant(variant: Optional[str], batch: int,
                    batch_threshold: int) -> str:
    """The JAX package's variant name for a batch: None names it by batch
    size (``batch_threshold`` items or more "block", fewer "fori"); a given
    name must be one of VARIANTS. Both names take the same launch here."""
    if variant is not None:
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        return variant
    return "block" if batch >= batch_threshold else "fori"


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


@functools.lru_cache(maxsize=256)
def tile_plan(capacity: int, batch: int) -> tuple[int, int, int, int]:
    """-> (tiles, slots a tile, item-list room, shared bytes a block) for a
    power-of-two ``capacity`` and a batch of ``batch`` items. Tiles and
    slots are powers of two, tiles x slots = capacity."""
    tiles = max(1, capacity // TILE_SLOTS)
    if batch > 0:  # each block walks the whole batch
        tiles = min(tiles, _pow2_floor(WALK_ITEMS // batch))
    tiles = max(tiles, capacity // MAX_TILE_SLOTS)
    slots = capacity // tiles
    expect = -(-batch * slots // capacity)
    room = min(MAX_ROOM, max(MIN_ROOM, 2 * expect))
    return tiles, slots, room, 4 * (HEADER_INTS + 5 * slots) + 8 * room


@functools.cache
def _launcher():
    return _build.libraries()["ledger"].ledger_record_priority


def _bad(name: str, x: torch.Tensor, dtype, n: int) -> ValueError:
    return ValueError(
        f"ledger_record_priority: {name} must be {n} {dtype} values on "
        f"ema's CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}")


def ledger_record_priority_cuda(
    ema: torch.Tensor,  # [capacity] f32
    count: torch.Tensor,  # [capacity] i32
    last_seen: torch.Tensor,  # [capacity] i32
    owner: torch.Tensor,  # [capacity] i32
    ids: torch.Tensor,  # [B] i32
    losses: torch.Tensor,  # [B] f32
    step: torch.Tensor,  # 0-dim i32 on the card
    valid: Optional[torch.Tensor],  # [B] bool, None = every item writes
    *,
    decay: float,
    unseen_priority: float,
    staleness_half_life: float,
) -> tuple[torch.Tensor, ...]:
    """Launch on the current stream -> (ema', count', last_seen', owner',
    priority [B] f32), disjoint views of one new buffer of 4 capacity + B
    f32 (count', last_seen' and owner' viewed as int32): a write into one
    leaves the others as they are, but any one of them keeps the whole
    buffer alive. The inputs are not modified. Inputs that are not
    contiguous are copied first."""
    dev = ema.get_device()
    cap = ema.shape[0]
    b = ids.shape[0]
    if dev < 0:
        raise ValueError("ledger_record_priority: ema must be a CUDA tensor")
    if cap <= 0 or cap & (cap - 1) or cap >= 2**31:
        raise ValueError(f"capacity {cap} must be a power of two below 2^31")
    f32, i32 = torch.float32, torch.int32
    checks = (("ema", ema, f32, cap), ("count", count, i32, cap),
              ("last_seen", last_seen, i32, cap), ("owner", owner, i32, cap),
              ("ids", ids, i32, b), ("losses", losses, f32, b),
              ("valid", valid, torch.bool, b))
    for name, x, dtype, n in checks:
        if x is not None and (x.dtype != dtype or x.get_device() != dev
                              or x.dim() != 1 or x.shape[0] != n):
            raise _bad(name, x, dtype, n)
    if step.dtype != i32 or step.get_device() != dev or step.numel() != 1:
        raise _bad("step", step, i32, 1)
    ins = [x if x is None or x.is_contiguous() else x.contiguous()
           for x in (ema, count, last_seen, owner, ids, losses, valid)]
    tiles, _, room, _ = tile_plan(cap, b)
    out = torch.empty(4 * cap + b, dtype=f32, device=ema.device)
    err = _launcher()(
        cap, tiles, room, *(x.data_ptr() for x in ins[:6]),
        None if valid is None else ins[6].data_ptr(), step.data_ptr(), b,
        float(decay), float(1.0 - decay), float(unseen_priority),
        float(staleness_half_life), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev))  # the current stream
    _build.check(err, "ledger_record_priority")
    e, c, ls, o, pri = out.split((cap, cap, cap, cap, b))
    return e, c.view(i32), ls.view(i32), o.view(i32), pri
