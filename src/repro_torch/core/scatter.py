"""Index writes that drop some items, without reading anything back to the
host (the decode step runs under CUDA sync checking)."""

from __future__ import annotations

import torch


def put_rows(
    dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
    keep: torch.Tensor,
) -> None:
    """``dst[idx[i]] = rows[i]`` for the ``keep`` items, in place; the other
    items write nothing. ``idx`` of kept items must be distinct.

    The JAX package drops a write by pointing it one past the end under
    ``mode="drop"``; torch has no drop mode and wraps negative indices, and
    filtering the rows would read the mask back to the host. Here a dropped
    item repeats the first kept item's write (same index, same row), so the
    duplicates agree and the result is exact whatever order they land in.
    With no kept item at all, every item rewrites ``dst[0]`` with itself.
    """
    # index_select, not a 0-dim tensor index, which would read it back
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    any_kept = keep.any()
    fill_idx = torch.where(any_kept, idx.index_select(0, first), 0)
    fill_row = torch.where(any_kept, rows.index_select(0, first), dst[:1])
    shape = (-1,) + (1,) * (rows.dim() - 1)
    dst.index_put_(
        (torch.where(keep, idx, fill_idx),),
        torch.where(keep.reshape(shape), rows, fill_row),
    )
