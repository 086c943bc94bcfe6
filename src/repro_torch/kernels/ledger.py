"""Wrapper of the CUDA recycle-ledger transaction (``csrc/ledger.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.ledger.ledger_record_priority``
in both of its variants. The source's header says what bounds it on the
H100 and how the design keeps the transaction's contract without the TPU
grid's program order; its plain version is
``kernels.ref.ledger_record_priority_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

VARIANTS = ("fori", "block")


def resolve_variant(variant: Optional[str], batch: int,
                    batch_threshold: int) -> str:
    """None dispatches by batch size: ``batch_threshold`` items or more take
    "block" (three grids over the items), fewer take "fori" (one block);
    "fori"/"block" force one."""
    if variant is not None:
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        return variant
    return "block" if batch >= batch_threshold else "fori"


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
    variant: str,
) -> tuple[torch.Tensor, ...]:
    """Launch on the current stream -> (ema', count', last_seen', owner',
    priority [B] f32); the inputs are not modified."""
    from repro_torch.kernels import _build

    tensors = {"ema": (ema, torch.float32), "count": (count, torch.int32),
               "last_seen": (last_seen, torch.int32),
               "owner": (owner, torch.int32), "ids": (ids, torch.int32),
               "losses": (losses, torch.float32), "step": (step, torch.int32)}
    if valid is not None:
        tensors["valid"] = (valid, torch.bool)
    for name, (x, dtype) in tensors.items():
        if not x.is_cuda or x.device != ema.device or x.dtype != dtype:
            raise ValueError(f"ledger_record_priority: {name} must be {dtype} "
                             f"on ema's CUDA device, got {x.dtype} on "
                             f"{x.device}")
    cap = ema.shape[0]
    b = ids.shape[0]
    if cap <= 0 or cap & (cap - 1) or cap >= 2**31:
        raise ValueError(f"capacity {cap} must be a power of two below 2^31")
    if (ema.dim() != 1 or any(x.shape != (cap,) for x in (count, last_seen,
                                                          owner))
            or ids.dim() != 1 or losses.shape != (b,) or step.numel() != 1
            or (valid is not None and valid.shape != (b,))):
        raise ValueError("ledger_record_priority: table arrays must be "
                         "[capacity], ids/losses/valid [B] and step one value")
    ins = [x.contiguous() for x in (ema, count, last_seen, owner)]
    ids, losses, step = ids.contiguous(), losses.contiguous(), step.contiguous()
    valid = None if valid is None else valid.contiguous()
    outs = [torch.empty_like(x) for x in ins]
    pri = torch.empty((b,), dtype=torch.float32, device=ema.device)
    last = torch.empty((cap,), dtype=torch.int32, device=ema.device)
    err = _build.libraries()["ledger"].ledger_record_priority(
        VARIANTS.index(variant), cap, *(x.data_ptr() for x in ins),
        ids.data_ptr(), losses.data_ptr(),
        None if valid is None else valid.data_ptr(), step.data_ptr(), b,
        float(decay), float(1.0 - decay), float(unseen_priority),
        float(staleness_half_life), *(x.data_ptr() for x in outs),
        pri.data_ptr(), last.data_ptr(),
        torch.cuda.current_stream(ema.device).cuda_stream,
    )
    _build.check(err, "ledger_record_priority")
    return (*outs, pri)
