"""Wrappers of the CUDA cross-entropy kernels (``csrc/xent.cu``).

Replace the Pallas TPU kernels ``repro.kernels.xent.xent_fwd`` and
``xent_bwd``. The source's header says what bounds them on the H100 and
what the design does about it; their plain versions are
``kernels.ref.xent_ref`` and ``kernels.ref.xent_grad_ref``.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(logits: torch.Tensor, labels: torch.Tensor, what: str) -> None:
    if not logits.is_cuda or logits.dim() != 2 or logits.dtype not in _DTYPES:
        raise ValueError(
            f"{what} takes 2-D float32 or bfloat16 CUDA logits, got "
            f"{logits.dtype} {tuple(logits.shape)} on {logits.device}"
        )
    if (labels.device != logits.device or labels.dtype != torch.int32
            or labels.shape != logits.shape[:1]):
        raise ValueError(
            f"{what}: labels must be int32 [T] on the logits' device, got "
            f"{labels.dtype} {tuple(labels.shape)} on {labels.device}"
        )


def _vec(logits: torch.Tensor) -> int:
    """1 when every row starts on a 16-byte boundary (16-byte loads)."""
    row_bytes = logits.shape[1] * logits.element_size()
    return int(row_bytes % 16 == 0 and logits.data_ptr() % 16 == 0)


def xent_fwd_cuda(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward on the current stream: logits [T,V] (f32 or bf16),
    labels [T] i32 (< 0 picks nothing; must be < V) -> (loss, lse) [T] f32."""
    from repro_torch.kernels import _build

    _check(logits, labels, "xent_fwd")
    logits, labels = logits.contiguous(), labels.contiguous()
    t, v = logits.shape
    loss = torch.empty((t,), dtype=torch.float32, device=logits.device)
    lse = torch.empty((t,), dtype=torch.float32, device=logits.device)
    if t == 0:
        return loss, lse
    err = _build.libraries()["xent"].xent_fwd(
        _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(), t, v,
        _vec(logits), loss.data_ptr(), lse.data_ptr(),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(err, "xent_fwd")
    return loss, lse


def xent_bwd_cuda(
    logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """Launch the backward on the current stream -> d(sum(g * loss))/d
    logits, [T,V] in logits' dtype."""
    from repro_torch.kernels import _build

    _check(logits, labels, "xent_bwd")
    t, v = logits.shape
    for name, x in (("lse", lse), ("g", g)):
        if (x.device != logits.device or x.dtype != torch.float32
                or x.shape != (t,)):
            raise ValueError(f"xent_bwd: {name} must be float32 [T] on the "
                             f"logits' device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    logits, labels = logits.contiguous(), labels.contiguous()
    lse, g = lse.contiguous(), g.contiguous()
    grad = torch.empty_like(logits)
    if t == 0:
        return grad
    err = _build.libraries()["xent"].xent_bwd(
        _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g.data_ptr(), t, v, _vec(logits), grad.data_ptr(),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(err, "xent_bwd")
    return grad
