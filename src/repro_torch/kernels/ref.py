"""Plain PyTorch versions of the kernels: what each kernel must compute.

Twins of the jnp oracles in ``repro.kernels.ref``. The kernel wrappers in
``kernels.ops`` take these for tensors on the CPU; on the card they are
what ``chip_smoke.py`` holds each kernel against.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
I32 = torch.int32


def xent_ref(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE: logits [T,V], labels [T] -> (loss [T], lse [T]) f32.
    A label outside [0, V) picks nothing, so its loss is the lse (below 0:
    the recorder's -1 "unknown" sentinel, which the model masks afterwards;
    at or past V, as the kernel does: the JAX package has no single answer
    there, its oracle gives NaN and its Pallas kernel 1e30)."""
    x = logits.to(F32)
    lse = torch.logsumexp(x, dim=-1)
    lab = labels.long()
    hit = (lab >= 0) & (lab < x.shape[-1])
    picked = x.gather(-1, torch.where(hit, lab, 0)[:, None])[:, 0]
    return lse - torch.where(hit, picked, 0.0), lse


def xent_grad_ref(
    logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """d(sum(g * loss))/d logits from the saved lse -> [T,V] in logits'
    dtype; a label outside [0, V) subtracts no one-hot."""
    p = torch.exp(logits.to(F32) - lse[:, None])
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols[None] == labels[:, None].long()).to(F32)
    return ((p - onehot) * g.to(F32)[:, None]).to(logits.dtype)


def ledger_record_priority_ref(
    ema: torch.Tensor,  # [capacity] f32
    count: torch.Tensor,  # [capacity] i32
    last_seen: torch.Tensor,  # [capacity] i32
    owner: torch.Tensor,  # [capacity] i32
    ids: torch.Tensor,  # [B] i32
    losses: torch.Tensor,  # [B] f32
    step,  # int or 0-dim i32
    decay: float,
    unseen_priority: float,
    staleness_half_life: float = float("inf"),
    valid=None,  # [B] bool, None = every item writes
) -> tuple[torch.Tensor, ...]:
    """One ledger transaction -> (ema', count', last_seen', owner',
    priority [B] f32), ``repro_torch.core.device_ledger`` semantics: new
    EMA/count from the pre-batch snapshot, the last valid item in batch
    order wins each slot, then every item (masked ones too) is scored
    against the updated table; an id evicted within the batch reads as
    unseen. The inputs are not modified."""
    from repro_torch.core.device_ledger import slot_for_torch

    cap = ema.shape[0]
    ids = ids.to(I32)
    losses = losses.to(F32)
    step = torch.as_tensor(step, device=ids.device).to(I32)
    slots = slot_for_torch(ids, cap)
    fresh = owner[slots] != ids
    prev = torch.where(fresh, losses, ema[slots])
    new_ema = decay * prev + (1.0 - decay) * losses
    new_count = torch.where(fresh, 1, count[slots] + 1).to(I32)
    order = torch.arange(ids.shape[0], device=ids.device)
    wslots = slots if valid is None else torch.where(valid, slots, cap)
    last = torch.full((cap + 1,), -1, dtype=order.dtype, device=ids.device)
    last = last.scatter_reduce(0, wslots, order, reduce="amax")
    win = (wslots < cap) & (last[slots] == order)  # distinct slots
    ema2, count2 = ema.clone(), count.clone()
    last_seen2, owner2 = last_seen.clone(), owner.clone()
    ema2[slots[win]] = new_ema[win]
    count2[slots[win]] = new_count[win]
    last_seen2[slots[win]] = step
    owner2[slots[win]] = ids[win]
    seen = owner2[slots] == ids
    age = torch.clamp(step - last_seen2[slots], min=0).to(F32)
    boost = torch.exp2(age / staleness_half_life)
    pri = torch.where(seen, ema2[slots] * boost, unseen_priority).to(F32)
    return ema2, count2, last_seen2, owner2, pri


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


def decode_attn_partials(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    valid: torch.Tensor,  # [B, T] bool
    span: int,
    read_empty: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense-cache kernel's spans, in f32: T cut into ceil(T / span)
    spans of ``span`` positions (the last one shorter) -> (m [B,Hkv,G,n]
    max score, l [B,Hkv,G,n] sum of exp(s - m), acc [B,Hkv,G,n,D] the
    unnormalised exp(s - m) . V) per span. Masked scores are -1e30, so a
    span with no valid position has m = -1e30. As in the kernel, such a
    span is not read when its row has a valid position elsewhere: its
    partial is (-1e30, 0, 0); with ``read_empty`` it is computed, with
    uniform weights (an all-masked row's spans always are).
    ``decode_attn_merge`` combines the spans."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    nsplit = -(-t // span)
    pad = nsplit * span - t
    qr = q.reshape(b, hkv, hq // hkv, d).to(F32)
    s = torch.einsum("bkgd,btkd->bkgt", qr, k.to(F32)) * (d**-0.5)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    # positions past T do not exist: exp(-inf - m) = 0 in every span
    s = F.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(*s.shape[:3], nsplit, span)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    vv = F.pad(v.to(F32), (0, 0, 0, 0, 0, pad)).reshape(b, nsplit, span,
                                                        hkv, d)
    acc = torch.einsum("bkgns,bnskd->bkgnd", p, vv)
    l_ = p.sum(dim=-1)
    if not read_empty:
        vs = F.pad(valid, (0, pad)).reshape(b, nsplit, span).any(dim=-1)
        skip = (~vs & vs.any(dim=-1, keepdim=True))[:, None, None, :]
        m = torch.where(skip, -1e30, m)
        l_ = torch.where(skip, 0.0, l_)
        acc = torch.where(skip[..., None], 0.0, acc)
    return m, l_, acc


def decode_attn_merge(
    m: torch.Tensor, l_: torch.Tensor, acc: torch.Tensor, dtype=F32
) -> torch.Tensor:
    """Merge ``decode_attn_partials``' spans -> [B, Hq, D] in ``dtype``:
    weights exp(m_i - M) with M the largest m_i, out = sum_i w_i acc_i /
    sum_i w_i l_i. A span with no valid position has weight
    exp(-1e30 - M) = 0 when its row has a valid score; an all-masked row
    weighs its spans by their lengths, which gives the mean of V."""
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mx)
    den = (l_ * w).sum(dim=-1).clamp_min(1e-30)
    out = (acc * w[..., None]).sum(dim=-2) / den[..., None]
    b, hkv, g, d = out.shape
    return out.reshape(b, hkv * g, d).to(dtype)


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


def ssd_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] positive
    a: torch.Tensor,  # [H] negative
    b: torch.Tensor,  # [B, S, G, N]
    c: torch.Tensor,  # [B, S, G, N]
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence, the definitional oracle:
    h_t = exp(a dt_t) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t
    -> (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32). The kernel's
    plain version is the chunked scan ``models.ssm.ssd_chunked``."""
    bsz, s, h, p = x.shape
    rep = h // b.shape[2]
    bh = b.to(F32).repeat_interleave(rep, dim=2)  # [B,S,H,N]
    ch = c.to(F32).repeat_interleave(rep, dim=2)
    xf, dtf, af = x.to(F32), dt.to(F32), a.to(F32)
    state = (torch.zeros((bsz, h, p, b.shape[3]), dtype=F32, device=x.device)
             if h0 is None else h0.to(F32))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])[..., None, None]
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * bh[:, t, :, None, :]
        state = state * decay + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype), state


def ssd_bwd_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] positive
    a: torch.Tensor,  # [H] negative
    b: torch.Tensor,  # [B, S, G, N]
    c: torch.Tensor,  # [B, S, G, N]
    states: torch.Tensor,  # [B, H, nc, P, N] f32, entering each chunk
    dy: torch.Tensor,  # [B, S, H, P]
    dfinal: Optional[torch.Tensor] = None,  # [B, H, P, N]; None = 0
    chunk: int = 128,
) -> tuple[torch.Tensor, ...]:
    """The chunked scan's gradient, written out (no autograd) -> (dx, ddt,
    da, dB, dC): dx, dB, dC in x's dtype, ddt and da f32, all computed in
    f32 and rounded once, as JAX's VJP through ``x.astype(F32)`` gives.

    Per (batch, head) and chunk of L steps, with cum_i = sum_{k<=i} a dt_k,
    total = cum_L, S the state entering the chunk, dS' the gradient of the
    state leaving it, M_ij = (C_i . B_j) e^{cum_i - cum_j} for j <= i (0
    above the diagonal) and q_ij = dy_i . x_j:
      dS_c   = e^{total_c} dS_{c+1} + sum_i e^{cum_i} dy_i C_i^T (reverse)
      dx_j   = dt_j sum_{i>=j} M_ij dy_i + e^{total-cum_j} dt_j dS' B_j
      dC_i   = sum_{j<=i} e^{cum_i-cum_j} dt_j q_ij B_j + e^{cum_i} S^T dy_i
      dB_j   = sum_{i>=j} e^{cum_i-cum_j} dt_j q_ij C_i
               + e^{total-cum_j} dt_j dS'^T x_j
      ddt_j  = sum_{i>=j} M_ij q_ij + e^{total-cum_j} x_j^T dS' B_j
               + a dda_j
    where dda_k = sum_{m>=k} g_m and g = d/d cum: each T_ij = M_ij dt_j
    q_ij adds to g_i and takes from g_j; g_i += e^{cum_i} dy_i^T S C_i;
    the state terms add e^{total} <dS', S> + sum_j e^{total-cum_j} dt_j
    x_j^T dS' B_j to g_L and take each j's share from g_j. da = sum_k dt_k
    dda_k; dB and dC are summed over a group's heads. A short last chunk
    is padded with dt = 0 steps, exact no-ops here as in the forward."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, nc = h // g, -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):  # [B, S, ...] -> f32 [B, nc, L, ...], zero-padded
        t = t.to(F32)
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xf, dyf, dtf = chunks(x), chunks(dy), chunks(dt)
    bh = chunks(b).repeat_interleave(rep, dim=3)  # [B,nc,L,H,N]
    ch = chunks(c).repeat_interleave(rep, dim=3)
    af = a.to(F32)
    cum = torch.cumsum(dtf * af, dim=2)  # [B,nc,L,H]
    total = cum[:, :, -1]  # [B,nc,H]
    ecum = torch.exp(cum)
    tail = torch.exp(total[:, :, None] - cum)  # e^{total - cum_j}
    st = states.to(F32).transpose(1, 2)  # [B,nc,H,P,N]

    # reverse state pass: gs[c] = dS', the gradient of the state leaving c
    u = torch.einsum("bclhp,bclhn->bchpn", dyf * ecum[..., None], ch)
    gcur = (torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
            if dfinal is None else dfinal.to(F32))
    gs = [None] * nc
    for ci in reversed(range(nc)):
        gs[ci] = gcur
        gcur = torch.exp(total[:, ci])[..., None, None] * gcur + u[:, ci]
    gs = torch.stack(gs, dim=1)  # [B,nc,H,P,N]

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Li,Lj,H]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    m = torch.einsum("bcihn,bcjhn->bcijh", ch, bh) * decay  # M_ij
    q = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)  # q_ij
    w = decay * q * dtf[:, :, None]  # e^{cum_i-cum_j} dt_j q_ij
    gb = torch.einsum("bchpn,bcjhn->bcjhp", gs, bh)  # dS' B_j
    sdy = torch.einsum("bchpn,bcihp->bcihn", st, dyf)  # S^T dy_i
    gx = torch.einsum("bchpn,bcjhp->bcjhn", gs, xf)  # dS'^T x_j
    dx = (dtf[..., None] * torch.einsum("bcijh,bcihp->bcjhp", m, dyf)
          + (tail * dtf)[..., None] * gb)
    dc = torch.einsum("bcijh,bcjhn->bcihn", w, bh) + ecum[..., None] * sdy
    db = (torch.einsum("bcijh,bcihn->bcjhn", w, ch)
          + (tail * dtf)[..., None] * gx)

    r = m * q  # M_ij q_ij
    xgb = (xf * gb).sum(-1)  # x_j^T dS' B_j
    sterm = tail * dtf * xgb
    t = r * dtf[:, :, None]  # T_ij
    gcum = (t.sum(dim=3) - t.sum(dim=2) + ecum * (sdy * ch).sum(-1)
            - sterm)
    gcum[:, :, -1] += torch.exp(total) * (gs * st).sum((-1, -2)) \
        + sterm.sum(dim=2)
    dda = torch.flip(torch.cumsum(torch.flip(gcum, [2]), dim=2), [2])
    ddt = r.sum(dim=2) + tail * xgb + af * dda

    def unchunk(t, dtype):  # [B, nc, L, ...] -> [B, S, ...]
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s].to(dtype)

    def group_sum(t):  # [B, nc, L, H, N] -> [B, nc, L, G, N]
        return t.reshape(*t.shape[:3], g, rep, n).sum(dim=4)

    return (unchunk(dx, x.dtype), unchunk(ddt, F32),
            (dtf * dda).sum((0, 1, 2)),
            unchunk(group_sum(db), b.dtype), unchunk(group_sum(dc), c.dtype))
