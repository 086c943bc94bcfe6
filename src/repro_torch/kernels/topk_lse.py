"""Wrapper of the CUDA top-k + logsumexp kernel (``csrc/topk_lse.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.topk_lse.topk_lse``. The
source's header says what bounds it on the H100 and how the radix select
answers that; its plain version is ``kernels.ref.topk_lse_ref``.
"""

from __future__ import annotations

import torch

# mirror the constants of csrc/topk_lse.cu
MAX_CLUSTER = 8  # blocks of one row: one thread-block cluster
# entries a block takes at least before a row is cut among more blocks
MIN_PER_BLOCK = 4096
# keys a block keeps in shared memory (128 KB); past it, a chunk's tail is
# read again in each pass
KEY_CACHE_MAX = 32768
# candidates (or survivors) the first block of a row holds and sorts in
# shared memory (32 KB), a power of two; past it, the k survivors are sorted
# in global scratch
SORT_SMEM_MAX = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_k(k: int, vocab: int) -> None:
    if not 0 < k <= vocab:
        raise ValueError(f"k={k} not in (0, {vocab}]")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def topk_plan(v: int, k: int, itemsize: int) -> tuple[int, int, int, int]:
    """How one call cuts a row -> (blocks C, chunk, keycap, nsort): the row
    in C <= MAX_CLUSTER chunks of ``chunk`` entries (a multiple of a 16-byte
    load's), at least MIN_PER_BLOCK each where the row allows; each block
    keeps ``keycap`` keys in shared memory; k survivors that overflow the
    first block's SORT_SMEM_MAX entries are sorted in global scratch of
    ``nsort`` (k rounded up to a power of two) entries a row."""
    e = 16 // itemsize
    c = max(1, min(MAX_CLUSTER, _cdiv(v, MIN_PER_BLOCK)))
    chunk = _cdiv(_cdiv(v, c), e) * e
    keycap = min(_cdiv(chunk, 8) * 8, KEY_CACHE_MAX)
    return _cdiv(v, chunk), chunk, keycap, 1 << (k - 1).bit_length()


def topk_lse_cuda(
    logits: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: logits [T,V] f32 or bf16 on
    the card -> (vals [T,k] f32, idx [T,k] i32, lse [T] f32), any k in
    (0, V]. A k past SORT_SMEM_MAX takes [T, nsort] int64 of scratch."""
    from repro_torch.kernels import _build

    if not logits.is_cuda or logits.dtype not in _DTYPES or logits.dim() != 2:
        raise ValueError(
            f"topk_lse kernel takes a 2-D float32 or bfloat16 CUDA tensor, "
            f"got {logits.dtype} {tuple(logits.shape)} on {logits.device}"
        )
    t, v = logits.shape
    check_k(k, v)
    logits = logits.contiguous()
    dev = logits.device
    vals = torch.empty((t, k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, k), dtype=torch.int32, device=dev)
    lse = torch.empty((t,), dtype=torch.float32, device=dev)
    if t == 0:
        return vals, idx, lse
    es = logits.element_size()
    c, chunk, keycap, nsort = topk_plan(v, k, es)
    scratch = (None if nsort <= SORT_SMEM_MAX else
               torch.empty((t, nsort), dtype=torch.int64, device=dev))
    vec = int((v * es) % 16 == 0 and logits.data_ptr() % 16 == 0)
    lib = _build.libraries()["topk_lse"]
    err = lib.topk_lse(
        _DTYPES[logits.dtype], logits.data_ptr(), t, v, k, c, chunk, keycap,
        SORT_SMEM_MAX, nsort, 0 if scratch is None else scratch.data_ptr(),
        vec, vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "topk_lse")
    return vals, idx, lse
