"""Wrappers of the CUDA decode-attention kernels (``csrc/decode_attn.cu``):
one kernel body for the paged pool and the dense cache.

They replace the Pallas TPU kernels
``repro.kernels.decode_attn.paged_decode_attn`` and ``decode_attn``. The
source's header says what bounds them on the H100 and what the design does
about that; their plain versions are ``kernels.ref.paged_decode_attn_ref``
and ``kernels.ref.decode_attn_ref``.
"""

from __future__ import annotations

import functools

import torch

# mirror the constants of csrc/decode_attn.cu
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_PER_BLOCK = 16  # query heads per block; a larger group is sliced
MAX_SPLIT = 8  # spans per (row, kv head): one thread-block cluster
MAX_TILE = 128  # positions a block stages at once
# shared memory for one tile's K and V rows: a block issues every copy of
# its tile at once, and about six such blocks fit an SM's 227 KB
TILE_BYTES = 36 * 1024
# blocks a call aims at when its tiles alone would leave SMs idle (about
# two and a half per SM of an H100): more spans, each merged in a cluster
TARGET_BLOCKS = 330


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)  # a decode loop repeats its few shapes
def split_plan(b: int, hq: int, hkv: int, t: int, d: int,
               itemsize: int) -> tuple[int, int, int, int, int]:
    """How the kernel cuts one call over blocks -> (gslices, gsz, nsplit,
    span, tile), for the dense cache of T = t positions or the paged pool
    at T = NP * page (the positions the table addresses): the group of
    G = hq / hkv query heads in ``gslices`` slices of at most ``gsz``
    heads; T in ``nsplit`` spans of ``span`` positions (the last one
    shorter), one block each; a block stages ``tile`` positions at once, as
    many as TILE_BYTES of padded K and V rows hold (a multiple of 16, at
    most MAX_TILE). A span is at most one tile where MAX_SPLIT spans allow
    it, so a block makes one round trip to memory; where that leaves the
    call short of TARGET_BLOCKS, T is cut into more spans (of at least 16
    positions); spans are of equal length. From shapes alone, never from a
    paged row's pos, so a call makes no host sync; a span past a row's
    context reads nothing."""
    g = hq // hkv
    gslices = _cdiv(g, GROUP_PER_BLOCK)
    gsz = _cdiv(g, gslices)
    rows = b * hkv * gslices
    rowb = _cdiv(d * itemsize, 16) * 16 + 16
    tile = max(16, min(MAX_TILE, TILE_BYTES // (2 * rowb) // 16 * 16))
    want = min(_cdiv(t, 16), round(TARGET_BLOCKS / rows))
    nsplit = max(1, min(MAX_SPLIT, max(_cdiv(t, tile), want)))
    span = _cdiv(t, nsplit)
    return gslices, gsz, _cdiv(t, span), span, min(tile, span)


def decode_attn_cuda(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    valid: torch.Tensor,  # [B, T] bool
) -> torch.Tensor:
    """Launch the dense-cache kernel on the current stream -> [B, Hq, D] in
    q's dtype: one grid over (row, kv head, head slice, span), the spans of
    a (row, kv head, slice) merged through shared memory within a
    thread-block cluster (``split_plan``). A row with no valid position
    gets the mean of V over all T, as the plain version does."""
    from repro_torch.kernels import _build

    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attn kernel supports D <= {MAX_HEAD_DIM}; "
                         f"got D={d}")
    if t == 0:
        raise ValueError("decode_attn: a cache of 0 positions")
    q, k, v, valid = (x if x.is_contiguous() else x.contiguous()
                      for x in (q, k, v, valid))
    out = torch.empty_like(q)
    if b == 0:
        return out
    gslices, gsz, nsplit, span, tile = split_plan(
        b, hq, hkv, t, d, q.element_size())
    vec = int((d * q.element_size()) % 16 == 0
              and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    lib = _build.libraries()["decode_attn"]
    err = lib.decode_attn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), out.data_ptr(), b, hq, hkv, d, t, float(d**-0.5),
        gslices, gsz, nsplit, span, tile, vec,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attn")
    return out


def paged_decode_attn_cuda(
    q: torch.Tensor,  # [B, Hq, D]
    kp: torch.Tensor,  # [P, page, Hkv, D]
    vp: torch.Tensor,  # [P, page, Hkv, D]
    page_table: torch.Tensor,  # [B, NP] i32
    pos: torch.Tensor,  # [B] i32
) -> torch.Tensor:
    """Launch the paged kernel on the current stream -> [B, Hq, D] in q's
    dtype, any group size (``split_plan`` at T = NP * page). Position t of row b is
    attended iff t <= pos[b] and its page is allocated; a row with none
    gets the mean of V over the NP * page positions the table addresses
    (a -1 page read as page 0), as the plain version does. An entry past
    the pool's end trips a device assert (which leaves the CUDA context
    unusable), as indexing the plain version with it raises."""
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
            or pos.shape != (b,) or hq % hkv or npg == 0):
        raise ValueError(
            f"paged_decode_attn: shapes q {tuple(q.shape)} kp "
            f"{tuple(kp.shape)} vp {tuple(vp.shape)} table "
            f"{tuple(page_table.shape)} pos {tuple(pos.shape)} disagree"
        )
    if d > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_attn kernel supports D <= "
                         f"{MAX_HEAD_DIM}; got D={d}")
    q, kp, vp, page_table, pos = (
        x if x.is_contiguous() else x.contiguous()
        for x in (q, kp, vp, page_table, pos))
    out = torch.empty_like(q)
    if b == 0:
        return out
    gslices, gsz, nsplit, span, tile = split_plan(
        b, hq, hkv, npg * page, d, q.element_size())
    vec = int((d * q.element_size()) % 16 == 0
              and kp.data_ptr() % 16 == 0 and vp.data_ptr() % 16 == 0)
    lib = _build.libraries()["decode_attn"]
    err = lib.paged_decode_attn(
        _DTYPES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, hq, hkv, d,
        page, npg, p_, float(d**-0.5), gslices, gsz, nsplit, span, tile, vec,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attn")
    return out
