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
from repro_torch.kernels import ledger as _ledger
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import topk_lse as _topk
from repro_torch.kernels import xent as _xent

IMPLS = ("ref", "cuda")
LAUNCHES = {"topk_lse": 0, "paged_decode_attn": 0, "decode_attn": 0,
            "xent_fwd": 0, "xent_bwd": 0, "ledger_record_priority": 0,
            "ssd": 0, "ssd_bwd": 0}


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
    lowest index. ``k`` must lie in (0, V]. The kernel reads f32 and bf16
    logits in their own dtype; other float dtypes are cast to f32 first."""
    _topk.check_k(k, logits.shape[-1])
    if _resolve(impl, logits) == "ref":
        return _ref.topk_lse_ref(logits, k)
    if logits.dtype not in (torch.float32, torch.bfloat16):
        logits = logits.to(torch.float32)
    out = _topk.topk_lse_cuda(logits, k)
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
    [B,Hq,D] in q's dtype, any group size. A row with no attended position
    gets the mean of V over the positions the table addresses."""
    if _resolve(impl, q) == "ref":
        return _ref.paged_decode_attn_ref(q, kp, vp, page_table, pos)
    out = _da.paged_decode_attn_cuda(
        q, kp, vp, page_table.to(torch.int32), pos.to(torch.int32)
    )
    LAUNCHES["paged_decode_attn"] += 1
    return out


def decode_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention against the dense cache: q [B,Hq,D], K/V
    [B,T,Hkv,D], valid [B,T] bool -> [B,Hq,D] in q's dtype. A row with no
    valid position gets the mean of V."""
    if _resolve(impl, q) == "ref":
        return _ref.decode_attn_ref(q, k, v, valid)
    if valid.dtype != torch.bool:
        valid = valid.to(torch.bool)
    out = _da.decode_attn_cuda(q, k, v, valid)
    LAUNCHES["decode_attn"] += 1
    return out


# ---------------------------------------------------------------------------
# per-token cross-entropy (forward and backward kernels)
# ---------------------------------------------------------------------------


def xent_fwd(
    logits: torch.Tensor, labels: torch.Tensor, impl: Optional[str] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [T,V], labels [T] -> (loss [T] f32, lse [T] f32); a label
    outside [0, V) picks nothing (loss = lse)."""
    if _resolve(impl, logits) == "ref":
        return _ref.xent_ref(logits, labels)
    out = _xent.xent_fwd_cuda(logits, labels.to(torch.int32))
    LAUNCHES["xent_fwd"] += 1
    return out


def xent_bwd(
    logits: torch.Tensor,
    labels: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """d(sum(g * loss))/d logits from the saved lse, [T,V] in logits'
    dtype."""
    if _resolve(impl, logits) == "ref":
        return _ref.xent_grad_ref(logits, labels, lse, g)
    out = _xent.xent_bwd_cuda(logits, labels.to(torch.int32),
                              lse.to(torch.float32), g.to(torch.float32))
    LAUNCHES["xent_bwd"] += 1
    return out


class _XentLoss(torch.autograd.Function):
    """The custom VJP of ``repro.kernels.ops.xent_loss``: the forward saves
    only the [T] lse beside its inputs (never a [T,V] softmax); the backward
    recomputes the gradient from (logits, lse)."""

    @staticmethod
    def forward(ctx, logits, labels, impl):
        loss, lse = xent_fwd(logits, labels, impl)
        ctx.save_for_backward(logits, labels, lse)
        ctx.impl = impl
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return xent_bwd(logits, labels, lse, g, ctx.impl), None, None


def xent_loss(
    logits: torch.Tensor, labels: torch.Tensor, impl: Optional[str] = None
) -> torch.Tensor:
    """Per-token CE, differentiable in ``logits``: [T,V], [T] -> [T] f32."""
    return _XentLoss.apply(logits, labels, impl)


# ---------------------------------------------------------------------------
# fused recycle-ledger record + priority
# ---------------------------------------------------------------------------

# The JAX package's threshold between its variant names: batches of at
# least this many items are named "block", smaller ones "fori". Both names
# take the same launch here (kernels.ledger: one block a table tile, every
# block walking the batch).
LEDGER_BLOCK_MIN_BATCH = 256


def ledger_record_priority(
    ema: torch.Tensor,
    count: torch.Tensor,
    last_seen: torch.Tensor,
    owner: torch.Tensor,
    ids: torch.Tensor,
    losses: torch.Tensor,
    step,
    *,
    decay: float,
    unseen_priority: float,
    staleness_half_life: float = float("inf"),
    valid: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    variant: Optional[str] = None,
) -> tuple[torch.Tensor, ...]:
    """One ledger transaction -> (ema', count', last_seen', owner', pri).

    ``valid`` ([B] bool) masks the write; masked items are still scored.
    ``step`` is an int or a 0-dim int tensor; on the card, pass an int32
    tensor on the table's device to keep the call free of host syncs and
    casts. ``variant`` is the JAX package's: None, "fori" or "block"; any
    of them takes the kernel's one launch, and the plain version ignores
    it. On the card the five outputs are disjoint views of one new buffer
    (``kernels.ledger.ledger_record_priority_cuda``): keeping any of them
    keeps the whole buffer."""
    _ledger.resolve_variant(variant, ids.shape[0], LEDGER_BLOCK_MIN_BATCH)
    if _resolve(impl, ema) == "ref":
        return _ref.ledger_record_priority_ref(
            ema, count, last_seen, owner, ids, losses, step, decay,
            unseen_priority, staleness_half_life, valid,
        )
    if not isinstance(step, torch.Tensor):  # a fill, not a host-to-device copy
        step = torch.full((), int(step), dtype=torch.int32, device=ema.device)
    elif step.dtype != torch.int32 or step.device != ema.device:
        step = step.reshape(()).to(device=ema.device, dtype=torch.int32)
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    if losses.dtype != torch.float32:
        losses = losses.to(torch.float32)
    if valid is not None and valid.dtype != torch.bool:
        valid = valid.to(torch.bool)
    out = _ledger.ledger_record_priority_cuda(
        ema, count, last_seen, owner, ids, losses, step, valid,
        decay=decay, unseen_priority=unseen_priority,
        staleness_half_life=staleness_half_life,
    )
    LAUNCHES["ledger_record_priority"] += 1
    return out


# ---------------------------------------------------------------------------
# SSD chunk scan
# ---------------------------------------------------------------------------


def _ssd_forward(x, dt, a, b, c, chunk, impl, keep_states):
    """The scan's forward by ``impl`` (already resolved): (y, final state)
    and, with ``keep_states``, the states entering each chunk."""
    if impl == "ref":
        from repro_torch.models.ssm import ssd_chunked

        return ssd_chunked(x, dt, a, b, c, chunk=chunk,
                           return_states=keep_states)
    out = _ssd.ssd_cuda(x, dt, a, b, c, chunk, keep_states=keep_states)
    LAUNCHES["ssd"] += 1
    return out


def ssd_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    states: torch.Tensor,
    dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None,
    chunk: int = 128,
    impl: Optional[str] = None,
) -> tuple[torch.Tensor, ...]:
    """The scan's gradient from the states entering each chunk [B,H,nc,P,N]
    f32, dy [B,S,H,P] and the final state's cotangent (None = 0) -> (dx,
    ddt, da, dB, dC), dx/dB/dC in x's dtype, ddt/da f32. Chunks of
    ``min(chunk, S)`` steps, as the forward took them. The kernel takes dt,
    a and the cotangent of the final state in f32 and dy in x's dtype, as
    ``_SSDScan`` gives them."""
    chunk = min(chunk, x.shape[1])
    if _resolve(impl, x) == "ref":
        return _ref.ssd_bwd_ref(x, dt, a, b, c, states, dy, dfinal,
                                chunk=chunk)
    out = _ssd.ssd_bwd_cuda(x, dt, a, b, c, states, dy, dfinal, chunk)
    LAUNCHES["ssd_bwd"] += 1
    return out


class _SSDScan(torch.autograd.Function):
    """The scan with its hand-written backward: the forward keeps the
    states entering each chunk beside its inputs (the kernel's own fold
    scratch on the card, ``ssd_chunked``'s on the CPU); the backward is
    ``ssd_bwd`` on them. An unused output's cotangent arrives as None."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk, impl):
        ctx.set_materialize_grads(False)
        y, final, states = _ssd_forward(x, dt, a, b, c, chunk, impl, True)
        ctx.save_for_backward(x, dt, a, b, c, states)
        ctx.chunk, ctx.impl = chunk, impl
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_bwd(x, dt, a, b, c, states, dy, dfinal, ctx.chunk,
                        ctx.impl)
        return (*grads, None, None)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    chunk: int = 128,
    impl: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 chunk scan: x [B,S,H,P], dt [B,S,H] (positive), a [H]
    (negative), B/C [B,S,G,N] -> (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] f32) in chunks of ``min(chunk, S)`` steps. The plain version
    is the chunked scan of ``models.ssm``, as in the JAX package.

    Differentiable: where autograd records and an input needs a gradient,
    the call goes through ``_SSDScan``, whose backward is ``ssd_bwd`` (the
    CUDA kernel on the card, ``ref.ssd_bwd_ref`` on the CPU); otherwise the
    forward alone runs and keeps nothing."""
    chunk = min(chunk, x.shape[1])
    impl = _resolve(impl, x)
    if impl == "cuda":
        dt, a = (t if t.dtype == torch.float32 else t.to(torch.float32)
                 for t in (dt, a))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        return _SSDScan.apply(x, dt, a, b, c, chunk, impl)
    return _ssd_forward(x, dt, a, b, c, chunk, impl, False)
