"""Plain PyTorch versions of the kernels: what each kernel must compute.

Twins of the jnp oracles in ``repro.kernels.ref``. The kernel wrappers in
``kernels.ops`` take these for tensors on the CPU; on the card they are
what ``chip_smoke.py`` holds each kernel against.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def topk_lse_ref(
    logits: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T,V] -> (vals [T,k] f32 descending, idx [T,k] i32, lse [T]
    f32). Ties resolve to the lowest vocab index (``jax.lax.top_k``
    semantics): a stable descending sort keeps equal values in index order,
    which ``torch.topk`` does not promise."""
    x = logits.to(F32)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32), torch.logsumexp(x, dim=-1)


def decode_attn_ref(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    valid: torch.Tensor,  # [B, T] bool
) -> torch.Tensor:
    """Single-token GQA decode attention -> [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    qr = q.reshape(b, hkv, hq // hkv, d).to(F32)
    scores = torch.einsum("bkgd,btkd->bkgt", qr, k.to(F32)) * (d**-0.5)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v.to(F32))
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attn_ref(
    q: torch.Tensor,  # [B, Hq, D]
    kp: torch.Tensor,  # [P, page, Hkv, D]
    vp: torch.Tensor,  # [P, page, Hkv, D]
    page_table: torch.Tensor,  # [B, NP] i32, -1 = unallocated
    pos: torch.Tensor,  # [B] i32; position pos is attended
) -> torch.Tensor:
    """Decode attention through the paged pool -> [B, Hq, D]: gather each
    row's pages into the dense layout (a -1 entry reads page 0, whose
    positions the mask then drops) and attend ``t <= pos``. A position on an
    unallocated page is masked too, as in the kernel; the JAX oracle leaves
    it unmasked, which only differs for rows the engine never reads."""
    b = q.shape[0]
    _, page, hkv, d = kp.shape
    t = page_table.shape[1] * page
    pt = page_table.long().clamp(min=0)
    k = kp[pt].reshape(b, t, hkv, d)
    v = vp[pt].reshape(b, t, hkv, d)
    tpos = torch.arange(t, device=q.device)
    allocated = (page_table >= 0).repeat_interleave(page, dim=1)
    valid = (tpos[None] <= pos[:, None].long()) & allocated
    return decode_attn_ref(q, k, v, valid)
