"""Public kernel entry points: dispatch by device, launch counters.

Each op picks its implementation from
  1. an explicit ``impl=`` argument (``"ref"`` or ``"cuda"``), else
  2. the device of its input: a CUDA tensor launches the hand-written
     kernel, a CPU tensor takes the plain PyTorch version in ``ref``.

A CUDA tensor never falls back to the plain version: the kernel launches or
the call raises. ``LAUNCHES`` counts the kernel launches of each op (and
only those), so a run can show which path it took.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import topk_lse as _topk

IMPLS = ("ref", "cuda")
LAUNCHES = {"topk_lse": 0, "paged_decode_attn": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _resolve(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def topk_lse(
    logits: torch.Tensor, k: int, impl: Optional[str] = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Retained-outcome summary of logits [T,V]: (top-k values [T,k] f32
    descending, their indices [T,k] i32, exact lse [T] f32); ties go to the
    lowest index. ``k`` must lie in (0, V]."""
    _topk.check_k(k, logits.shape[-1])
    if _resolve(impl, logits) == "ref":
        return _ref.topk_lse_ref(logits, k)
    out = _topk.topk_lse_cuda(logits.to(torch.float32), k)
    LAUNCHES["topk_lse"] += 1
    return out


def paged_decode_attn(
    q: torch.Tensor,
    kp: torch.Tensor,
    vp: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention through the paged KV pool: q [B,Hq,D], pools
    [P,page,Hkv,D], page_table [B,NP] (-1 = unallocated), pos [B] ->
    [B,Hq,D]."""
    if _resolve(impl, q) == "ref":
        return _ref.paged_decode_attn_ref(q, kp, vp, page_table, pos)
    out = _da.paged_decode_attn_cuda(
        q, kp, vp, page_table.to(torch.int32), pos.to(torch.int32)
    )
    LAUNCHES["paged_decode_attn"] += 1
    return out
