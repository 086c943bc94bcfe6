"""Wrapper of the CUDA top-k + logsumexp kernel (``csrc/topk_lse.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.topk_lse.topk_lse``. The
source's header says what bounds it on the H100 and how the two-pass design
answers that; its plain version is ``kernels.ref.topk_lse_ref``.
"""

from __future__ import annotations

import torch

# mirror the constants of csrc/topk_lse.cu
KMAX = 64  # largest k the kernel selects
CHUNK = 4096  # vocab entries per pass-1 block
MAX_CAND = 4096  # pass-2 candidates per row: ceil(V / CHUNK) * k


def check_k(k: int, vocab: int) -> None:
    if not 0 < k <= vocab:
        raise ValueError(f"k={k} not in (0, {vocab}]")


def topk_lse_cuda(
    logits: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: logits [T,V] f32 contiguous
    on the card -> (vals [T,k] f32, idx [T,k] i32, lse [T] f32)."""
    from repro_torch.kernels import _build

    if not logits.is_cuda or logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError(
            f"topk_lse kernel takes a 2-D float32 CUDA tensor, got "
            f"{logits.dtype} {tuple(logits.shape)} on {logits.device}"
        )
    t, v = logits.shape
    check_k(k, v)
    chunks = -(-v // CHUNK)
    if k > KMAX or chunks * k > MAX_CAND:
        raise ValueError(
            f"topk_lse kernel supports k <= {KMAX} and ceil(V/{CHUNK})*k <= "
            f"{MAX_CAND}; got k={k}, V={v}"
        )
    logits = logits.contiguous()
    dev = logits.device
    vals = torch.empty((t, k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, k), dtype=torch.int32, device=dev)
    lse = torch.empty((t,), dtype=torch.float32, device=dev)
    if t == 0:
        return vals, idx, lse
    part_v = torch.empty((t, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((t, chunks, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((t, chunks), dtype=torch.float32, device=dev)
    part_s = torch.empty((t, chunks), dtype=torch.float32, device=dev)
    lib = _build.libraries()["topk_lse"]
    err = lib.topk_lse_f32(
        logits.data_ptr(), t, v, k, part_v.data_ptr(), part_i.data_ptr(),
        part_m.data_ptr(), part_s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        lse.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "topk_lse")
    return vals, idx, lse
