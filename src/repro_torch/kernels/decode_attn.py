"""Wrappers of the CUDA decode-attention kernels: the paged one
(``csrc/paged_decode_attn.cu``) and the dense-cache one
(``csrc/decode_attn.cu``).

They replace the Pallas TPU kernels
``repro.kernels.decode_attn.paged_decode_attn`` and ``decode_attn``. Each
source's header says what bounds it on the H100 and what its design does
about that; their plain versions are ``kernels.ref.paged_decode_attn_ref``
and ``kernels.ref.decode_attn_ref``.
"""

from __future__ import annotations

import torch

# mirror the constants of csrc/paged_decode_attn.cu and csrc/decode_attn.cu
MAX_GROUP = 8  # query heads per kv head
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attn_cuda(
    q: torch.Tensor,  # [B, Hq, D]
    kp: torch.Tensor,  # [P, page, Hkv, D]
    vp: torch.Tensor,  # [P, page, Hkv, D]
    page_table: torch.Tensor,  # [B, NP] i32
    pos: torch.Tensor,  # [B] i32
) -> torch.Tensor:
    """Launch the kernel on the current stream -> [B, Hq, D] in q's dtype.

    A table entry of -1 masks its page; an entry past the pool's end trips
    a device assert (which leaves the CUDA context unusable), as indexing
    the plain version with it raises."""
    from repro_torch.kernels import _build

    tensors = {"q": q, "kp": kp, "vp": vp, "page_table": page_table, "pos": pos}
    for name, x in tensors.items():
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"paged_decode_attn: {name} must be on q's CUDA "
                             f"device, got {x.device}")
    if q.dtype not in _DTYPES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise ValueError(f"paged_decode_attn: q/kp/vp must share float32 or "
                         f"bfloat16, got {q.dtype}/{kp.dtype}/{vp.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_decode_attn: page_table and pos must be int32")
    b, hq, d = q.shape
    p_, page, hkv, d2 = kp.shape
    npg = page_table.shape[1]
    if (vp.shape != kp.shape or d2 != d or page_table.shape[0] != b
            or pos.shape != (b,) or hq % hkv):
        raise ValueError(
            f"paged_decode_attn: shapes q {tuple(q.shape)} kp "
            f"{tuple(kp.shape)} vp {tuple(vp.shape)} table "
            f"{tuple(page_table.shape)} pos {tuple(pos.shape)} disagree"
        )
    g = hq // hkv
    if g > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(
            f"paged_decode_attn kernel supports G <= {MAX_GROUP} and D <= "
            f"{MAX_HEAD_DIM}; got G={g}, D={d}"
        )
    q, kp, vp = q.contiguous(), kp.contiguous(), vp.contiguous()
    page_table, pos = page_table.contiguous(), pos.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.libraries()["paged_decode_attn"]
    err = lib.paged_decode_attn(
        _DTYPES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, page, npg, p_, float(d**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attn")
    return out


def decode_attn_cuda(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    valid: torch.Tensor,  # [B, T] bool
) -> torch.Tensor:
    """Launch the dense-cache kernel on the current stream -> [B, Hq, D] in
    q's dtype. A row with no valid position gets the mean of V over all T,
    as the plain version does."""
    from repro_torch.kernels import _build

    for name, x in {"q": q, "k": k, "v": v, "valid": valid}.items():
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"decode_attn: {name} must be on q's CUDA "
                             f"device, got {x.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attn: q/k/v must share float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"decode_attn: valid must be bool, got {valid.dtype}")
    b, hq, d = q.shape
    _, t, hkv, d2 = k.shape
    if (k.shape[0] != b or v.shape != k.shape or d2 != d
            or valid.shape != (b, t) or hq % hkv):
        raise ValueError(
            f"decode_attn: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} valid {tuple(valid.shape)} disagree"
        )
    g = hq // hkv
    if g > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(
            f"decode_attn kernel supports G <= {MAX_GROUP} and D <= "
            f"{MAX_HEAD_DIM}; got G={g}, D={d}"
        )
    if t == 0:
        raise ValueError("decode_attn: a cache of 0 positions")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.libraries()["decode_attn"]
    err = lib.decode_attn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), out.data_ptr(), b, hq, hkv, d, t, float(d**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attn")
    return out
