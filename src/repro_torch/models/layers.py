"""Transformer layer primitives of the dense GQA family.

The PyTorch counterpart of ``repro.models.layers``, with its conventions:
activations in ``cfg.compute_dtype``, norms, softmax and attention scores in
f32; every attention entry point has a full-sequence form (prefill) and a
single-token decode form against a KV cache. Public functions keep the JAX
package's layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, caches
``[B, T, kv, hd]``, page pools ``[P, page, kv, hd]``).

Decode writes K/V into the cache tensors in place (the JAX version returns
new arrays and donates the old ones), then attends through
``kernels.ops.decode_attn`` (dense cache) or ``paged_decode_attn`` (page
pool). The dense cache holds bf16 or int8 K/V (per-(position, head) f32
scales) and, with a sliding window, a rolling layout of ``window`` slots.
Attention takes any group size, MHA (deepseek-7b) to MQA (granite-34b),
with or without qk-norm (qwen3-14b), or is DeepSeek-V2's multi-head latent
attention (MLA: a compressed latent cache ``ckv [B, T, R]`` and ``kpe
[B, T, pe]``, decoded with absorbed weights in plain einsums, as the JAX
package computes it; no kernel); the FFN is SwiGLU or the GELU MLP
(granite-34b).

Under a model axis (tensor parallelism, ``distributed.sharding``'s
regions) ``gqa_attend`` and ``mlp`` run on the rank's slice of the heads
and of the MLP columns: the local head counts come from the held weights'
shapes, never from ``cfg``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.scatter import put_rows
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

F32 = torch.float32
_MASK_VALUE = -1e30


def _require_plain_gqa(cfg: ModelConfig) -> None:
    if cfg.attn_impl != "gqa":
        raise NotImplementedError(
            f"attention {cfg.attn_impl!r}: the GQA cache does not hold it")


# ---------------------------------------------------------------------------
# norms / rope / masks
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    rms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


def rmsnorm_spec(d: int, axis: Optional[str] = "embed") -> ParamSpec:
    return ParamSpec((d,), (axis,), init="ones")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim. x [..., S, H, D]; positions [S]
    or [B, S] (every row at its own depth)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=F32) / d))
    ang = positions.to(F32)[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int] = None
) -> torch.Tensor:
    """[S_q, S_k] boolean keep-mask: causal, optionally windowed."""
    keep = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        keep &= k_pos[None, :] > (q_pos[:, None] - window)
    return keep


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def gqa_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d**-0.5
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), scale=s),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        scale=s),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        scale=s),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        scale=(h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_spec(hd, "head_dim")
        p["k_norm"] = rmsnorm_spec(hd, "head_dim")
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,d] @ w [d,H,hd] -> [B,S,H,hd]."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o [B,S,H,hd] @ wo [H,hd,d] -> [B,S,d]."""
    h, hd, d = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * hd, d)


def _qkv(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _qkv_cut(x: torch.Tensor, p: dict, cfg: ModelConfig,
             positions: torch.Tensor, cut: "HeadCut"):
    """``_qkv`` on this rank's slice of the heads (its q heads global
    ``[m*h, (m+1)*h)``, h the local count, read from ``wq``'s held shape),
    each replicated tensor entering the region once
    (``sharding.enter``; the rule is the sharding module's): ``x`` before
    the cut projections; ``q_norm`` (it acts on cut heads); with the kv
    heads cut too, ``k_norm``, and each rank's kv heads are the ones its q
    heads use already (JAX's grouping of q head i with kv head i // G);
    with the kv heads whole, k and v after their norm and rope, then
    ``_kv_for_heads`` picks the kv heads the rank's q heads use."""
    norm = cfg.qk_norm
    if cut.kv:
        xs = SH.enter(x, p["q_norm"], p["k_norm"]) if norm else (
            SH.enter(x),)
        xe = xs[0]
        q, k, v = (_proj_heads(xe, p[w]) for w in ("wq", "wk", "wv"))
        if norm:
            q = rmsnorm(q, xs[1], cfg.norm_eps)
            k = rmsnorm(k, xs[2], cfg.norm_eps)
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta), v)
    xs = SH.enter(x, p["q_norm"]) if norm else (SH.enter(x),)
    q = _proj_heads(xs[0], p["wq"])
    k, v = _proj_heads(x, p["wk"]), _proj_heads(x, p["wv"])
    if norm:
        q = rmsnorm(q, xs[1], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    k, v = SH.enter(rope(k, positions, cfg.rope_theta), v)
    k, v = _kv_for_heads(k, v, cut.index * q.shape[2], q.shape[2],
                         cfg.num_heads // cfg.num_kv_heads)
    return rope(q, positions, cfg.rope_theta), k, v


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, first: int, h: int,
                  g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole kv heads [B,T,KV,D] -> the one kv head that q heads
    ``[first, first+h)`` use (q head i takes kv head i // g), for
    ``_gqa_core``'s grouping: with the kv heads whole and the heads cut,
    a rank's h heads lie in one group where h divides g
    (``models.model.tensor_parallel_refusal`` refuses the rest)."""
    if g % h:
        raise NotImplementedError(
            f"q heads [{first}, {first + h}) span part of a kv group of {g}")
    return k.narrow(2, first // g, 1), v.narrow(2, first // g, 1)


@dataclasses.dataclass(frozen=True)
class HeadCut:
    """How the model axis cuts one attention block's heads: this rank's
    index on the axis, and whether the kv heads are cut too (else whole on
    every rank). Heads the axis leaves whole run replicated, with no
    ``HeadCut``."""

    index: int
    kv: bool


def _gqa_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keep: torch.Tensor
) -> torch.Tensor:
    """q [B,S,Hq,D]; k,v [B,T,Hkv,D]; keep [S,T] or [B,S,T] -> [B,S,Hq,D]."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(F32), k.to(F32)) * (d**-0.5)
    keep_b = keep if keep.dim() == 3 else keep[None]
    scores = torch.where(keep_b[:, None, None], scores, _MASK_VALUE)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, hq, d)


def _gqa_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    window: Optional[int],
    block: int = 1024,
) -> torch.Tensor:
    """Causal attention blocked over queries and keys with an online
    softmax, so no [S, S] score matrix is built: the long-prompt path.
    q/k [.., D], v [.., Dv] (MLA's V is narrower than its q/k); the scale
    is D^-0.5."""
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    out = q.new_empty((b, s, hq, dv))
    scale = d**-0.5
    for q0 in range(0, s, block):
        qi = q[:, q0:q0 + block].reshape(b, -1, hkv, g, d).to(F32)
        pq = positions[q0:q0 + block]
        m = torch.full((b, hkv, g, qi.shape[1]), _MASK_VALUE, dtype=F32,
                       device=q.device)
        l_ = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, qi.shape[1], dv), dtype=F32,
                          device=q.device)
        for k0 in range(0, s, block):
            kj = k[:, k0:k0 + block].to(F32)
            vj = v[:, k0:k0 + block]
            pk = positions[k0:k0 + block]
            s_ij = torch.einsum("bqkgd,btkd->bkgqt", qi, kj) * scale
            keep = pk[None, :] <= pq[:, None]
            if window is not None:
                keep &= pk[None, :] > (pq[:, None] - window)
            s_ij = torch.where(keep, s_ij, _MASK_VALUE)
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            p_ij = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_ = l_ * corr + p_ij.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p_ij.to(vj.dtype), vj
            ).to(F32)
            m = m_new
        o = (acc / l_.clamp(min=1e-30)[..., None]).to(q.dtype)
        out[:, q0:q0 + block] = o.permute(0, 3, 1, 2, 4).reshape(b, -1, hq,
                                                                 dv)
    return out


def _attend_full(q, k, v, positions, cfg: ModelConfig) -> torch.Tensor:
    if q.shape[1] >= cfg.blocked_attn_min:
        return _gqa_blocked(q, k, v, positions, cfg.sliding_window)
    keep = causal_mask(positions, positions, cfg.sliding_window)
    return _gqa_core(q, k, v, keep)


def gqa_attend(
    x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor,
    cut: Optional[HeadCut] = None,
) -> torch.Tensor:
    """Full-sequence attention. x [B,S,D] -> [B,S,D]. With ``cut`` the
    rank holds its slice of the heads (``wq``, ``wo``; ``wk``, ``wv`` where
    ``cut.kv``), attends over them, and the output projection's partial
    sums leave the region summed over the model axis."""
    if cut is None:
        q, k, v = _qkv(x, p, cfg, positions)
        return _out_proj(_attend_full(q, k, v, positions, cfg), p["wo"])
    q, k, v = _qkv_cut(x, p, cfg, positions, cut)
    return SH.leave(_out_proj(_attend_full(q, k, v, positions, cfg),
                              p["wo"]))


def gqa_cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Slots of the dense cache: ``max_seq``, or the window's rolling
    ``sliding_window`` slots when that is shorter."""
    return min(max_seq, cfg.sliding_window or max_seq)


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, f32 scale over the head dim). ``round``
    is half to even in both packages."""
    xf = x.to(F32)
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(F32) * scale[..., None].to(F32)).to(dtype)


def gqa_init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
    device: torch.device | str,
) -> dict:
    """One layer's dense cache [B, T, kv, hd], T = ``gqa_cache_len``; int8
    K/V carry ``k_scale``/``v_scale`` [B, T, kv] in f32."""
    _require_plain_gqa(cfg)
    t = gqa_cache_len(cfg, max_seq)
    shape = (batch, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=F32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=F32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_fill_cache(
    x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Prefill: (output, cache holding the last ``gqa_cache_len`` tokens).
    A rolling window keeps slot j for the position p with p % t == j."""
    _require_plain_gqa(cfg)
    q, k, v = _qkv(x, p, cfg, positions)
    out = _out_proj(_attend_full(q, k, v, positions, cfg), p["wo"])
    t = gqa_cache_len(cfg, max_seq)
    s = x.shape[1]
    if t >= s:
        pad = (0, 0, 0, 0, 0, t - s)
        cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    else:
        cache = {"k": torch.roll(k[:, s - t:], s % t, dims=1),
                 "v": torch.roll(v[:, s - t:], s % t, dims=1)}
    if cfg.kv_cache_dtype == "int8":
        qk, sk = _kv_quant(cache["k"])
        qv, sv = _kv_quant(cache["v"])
        cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    return out, cache


def gqa_decode(
    x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict,
    pos: torch.Tensor, max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode against the dense cache, written in place.
    x [B,1,D]; pos = tokens already cached, a scalar (whole batch at one
    depth) or a [B] vector (every row at its own depth).

    The new row lands in slot ``pos % t``; slot j then holds position
    ``pos - ((pos - j) mod t)``, attended if it is >= 0 and, with a window,
    inside it. Attention runs through ``kernels.ops.decode_attn`` (the CUDA
    kernel on the card), which keeps the softmax weights in f32 where the
    JAX package's einsum rounds them to the compute dtype first."""
    _require_plain_gqa(cfg)
    b = x.shape[0]
    t = gqa_cache_len(cfg, max_seq)
    per_slot = pos.dim() == 1 and pos.shape[0] == b
    rope_pos = pos[:, None] if per_slot else pos.reshape(1)
    q, k, v = _qkv(x, p, cfg, rope_pos)
    slot = pos.long() % t
    if per_slot:
        bidx = torch.arange(b, device=x.device)

        def upd(c, n):  # row slot[b] of example b
            c[bidx, slot] = n[:, 0]
    else:

        def upd(c, n):
            c.index_copy_(1, slot.reshape(1), n)

    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k), ("v", v)):
            qn, sn = _kv_quant(new)
            upd(cache[name], qn)
            upd(cache[f"{name}_scale"], sn)
        ck = _kv_dequant(cache["k"], cache["k_scale"], x.dtype)
        cv = _kv_dequant(cache["v"], cache["v_scale"], x.dtype)
    else:
        upd(cache["k"], k)
        upd(cache["v"], v)
        ck, cv = cache["k"], cache["v"]
    j = torch.arange(t, device=x.device)
    posq = pos.long()[:, None] if per_slot else pos.long().reshape(1, 1)
    slot_pos = posq - torch.remainder(posq - j, t)  # [B,T] or [1,T]
    valid = slot_pos >= 0
    if cfg.sliding_window is not None:
        valid &= slot_pos > posq - cfg.sliding_window
    o = kops.decode_attn(q[:, 0], ck, cv, valid.expand(b, t))
    return _out_proj(o[:, None].to(x.dtype), p["wo"]), cache


def gqa_paged_init_cache(
    cfg: ModelConfig, num_pages: int, page_size: int, dtype: torch.dtype,
    device: torch.device | str,
) -> dict:
    """One layer's slice of the global KV page pool: [P, page, kv, hd].
    Rolling windows and int8 K/V keep the dense layout, as in the JAX
    package."""
    _require_plain_gqa(cfg)
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "paged KV cache requires plain GQA without a sliding window")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("paged KV cache: int8 KV not supported yet")
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_paged_decode(
    x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict,
    page_table: torch.Tensor, pos: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode through the paged KV pool.

    x [B,1,D]; cache {"kp","vp": [P, page, kv, hd]}; page_table [B, NP]
    (-1 = unallocated: a write through it is dropped, so a freed slot never
    scribbles on a page that moved on to another owner); pos [B]. The new
    K/V row is written into the pool in place, then attention reads the
    pool through the table via ``kernels.ops.paged_decode_attn`` (the CUDA
    kernel on the card, its plain version on the CPU).
    """
    _require_plain_gqa(cfg)
    kp, vp = cache["kp"], cache["vp"]
    ps = kp.shape[1]
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg, pos[:, None])
    bidx = torch.arange(b, device=x.device)
    page = page_table[bidx, pos.long() // ps].long()  # -1 when unallocated
    flat = page * ps + pos.long() % ps
    keep = page >= 0
    put_rows(kp.view(-1, *kp.shape[2:]), flat, k[:, 0], keep)
    put_rows(vp.view(-1, *vp.shape[2:]), flat, v[:, 0], keep)
    o = kops.paged_decode_attn(q[:, 0], kp, vp, page_table, pos)
    return _out_proj(o[:, None].to(x.dtype), p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    nope, pe, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    s = d**-0.5
    return {
        "wq_a": ParamSpec((d, qr), ("embed", "q_lora"), scale=s),
        "q_norm": rmsnorm_spec(qr, "q_lora"),
        "wq_b": ParamSpec((qr, h, nope + pe), ("q_lora", "heads", "head_dim"),
                          scale=qr**-0.5),
        "wkv_a": ParamSpec((d, r + pe), ("embed", "kv_lora"), scale=s),
        "kv_norm": rmsnorm_spec(r, "kv_lora"),
        "wkv_b": ParamSpec((r, h, nope + vd), ("kv_lora", "heads", "head_dim"),
                           scale=r**-0.5),
        "wo": ParamSpec((h, vd, d), ("heads", "head_dim", "embed"),
                        scale=(h * vd) ** -0.5),
    }


def _mla_q(x: torch.Tensor, p: dict, cfg: ModelConfig,
           positions: torch.Tensor):
    """-> (q_nope [B,S,H,nope], roped q_pe [B,S,H,pe])."""
    nope = cfg.qk_nope_head_dim
    cq = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = _proj_heads(cq, p["wq_b"])
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_kv_latent(x: torch.Tensor, p: dict, cfg: ModelConfig,
                   positions: torch.Tensor):
    """-> (normed latent ckv [B,S,R], roped k_pe [B,S,pe], shared by every
    head): what the cache holds."""
    r = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"].to(x.dtype)
    ckv = rmsnorm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = rope(kv_a[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, k_pe


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def mla_attend(
    x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor
) -> torch.Tensor:
    """Full-sequence MLA (train/prefill): the latent expanded into K/V by
    ``wkv_b``, whose last dim splits into the K half (nope) and the V half.
    From ``blocked_attn_min`` tokens the nope and rope halves join into one
    q/k dim (k_pe broadcast over the heads) for ``_gqa_blocked``, whose
    D^-0.5 is MLA's scale. Scores in f32, the softmax weights rounded to
    the compute dtype before the value product, as in the JAX package."""
    dt = x.dtype
    nope = cfg.qk_nope_head_dim
    q_nope, q_pe = _mla_q(x, p, cfg, positions)
    ckv, k_pe = _mla_kv_latent(x, p, cfg, positions)
    kv = _proj_heads(ckv, p["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    if x.shape[1] >= cfg.blocked_attn_min:
        qcat = torch.cat([q_nope, q_pe], dim=-1)
        kcat = torch.cat(
            [k_nope, k_pe[:, :, None].expand(-1, -1, cfg.num_heads, -1)],
            dim=-1)
        out = _gqa_blocked(qcat, kcat, v, positions, None)
    else:
        scores = (torch.einsum("bshk,bthk->bhst", q_nope.to(F32),
                               k_nope.to(F32))
                  + torch.einsum("bshk,btk->bhst", q_pe.to(F32),
                                 k_pe.to(F32))) * _mla_scale(cfg)
        keep = causal_mask(positions, positions)
        scores = torch.where(keep, scores, _MASK_VALUE)
        w = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhst,bthv->bshv", w, v)
    return _out_proj(out, p["wo"])


def mla_init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
    device: torch.device | str,
) -> dict:
    """One layer's latent cache: ``ckv`` [B, T, R] and ``kpe`` [B, T, pe],
    R + pe values a token (576 for deepseek-v2-236b) for every head."""
    return {
        "ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kpe": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
    }


def mla_fill_cache(
    x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Prefill: (output, the latent cache padded to ``max_seq``)."""
    out = mla_attend(x, p, cfg, positions)
    ckv, k_pe = _mla_kv_latent(x, p, cfg, positions)
    pad = (0, 0, 0, max_seq - x.shape[1])
    return out, {"ckv": F.pad(ckv, pad), "kpe": F.pad(k_pe, pad)}


def mla_decode(
    x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict,
    pos: torch.Tensor, max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Absorbed-weight decode in the latent space, the cache written in
    place. x [B,1,D]; pos a scalar or a [B] vector (each row ropes its
    token and masks its cache at its own depth).

    wkv_b's K half is absorbed into q (q_lat [B,1,H,R]) and its V half
    applied after the weighted latent sum, so nothing of size [T, H, hd] is
    built. Scores in f32 over the cache's ``max_seq`` slots, softmax
    weights rounded to the compute dtype before the latent sum, as the JAX
    ``mla_decode`` rounds them."""
    dt = x.dtype
    nope = cfg.qk_nope_head_dim
    b = x.shape[0]
    per_slot = pos.dim() == 1 and pos.shape[0] == b
    rope_pos = pos[:, None] if per_slot else pos.reshape(1)
    q_nope, q_pe = _mla_q(x, p, cfg, rope_pos)
    ckv_new, kpe_new = _mla_kv_latent(x, p, cfg, rope_pos)
    ckv, kpe = cache["ckv"], cache["kpe"]
    if per_slot:
        bidx = torch.arange(b, device=x.device)
        ckv[bidx, pos.long()] = ckv_new[:, 0]
        kpe[bidx, pos.long()] = kpe_new[:, 0]
    else:
        ckv.index_copy_(1, pos.long().reshape(1), ckv_new)
        kpe.index_copy_(1, pos.long().reshape(1), kpe_new)
    wkv = p["wkv_b"].to(dt)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wkv[..., :nope])
    scores = (torch.einsum("bshr,btr->bhst", q_lat.to(F32), ckv.to(F32))
              + torch.einsum("bshk,btk->bhst", q_pe.to(F32), kpe.to(F32))
              ) * _mla_scale(cfg)
    posq = pos.long()[:, None] if per_slot else pos.long().reshape(1, 1)
    valid = torch.arange(max_seq, device=x.device)[None] <= posq  # [B|1, T]
    scores = torch.where(valid[:, None, None], scores, _MASK_VALUE)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhst,btr->bshr", w, ckv)
    out = torch.einsum("bshr,rhv->bshv", ctx, wkv[..., nope:])
    return _out_proj(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU, or the two-matrix GELU MLP)
# ---------------------------------------------------------------------------


def mlp_specs(d: int, f: int, gelu: bool = False) -> dict[str, ParamSpec]:
    """SwiGLU's ``w1``/``w3``/``w2``, or with ``gelu`` the GPTBigCode-style
    MLP's ``w1``/``w2`` alone (granite)."""
    p = {
        "w1": ParamSpec((d, f), ("embed", "mlp"), scale=d**-0.5),
        "w2": ParamSpec((f, d), ("mlp", "embed"), scale=f**-0.5),
    }
    if not gelu:  # SwiGLU gate
        p["w3"] = ParamSpec((d, f), ("embed", "mlp"), scale=d**-0.5)
    return p


def mlp(x: torch.Tensor, p: dict, cut: bool = False) -> torch.Tensor:
    """SwiGLU where the tree has ``w3``, else GELU in its tanh form, which
    is ``jax.nn.gelu``'s default (torch's default is the erf form, up to
    4.7e-4 away). With ``cut`` the rank holds its columns of ``w1``/``w3``
    and rows of ``w2`` (the model axis's slice of ``mlp``): ``x`` enters
    the region and the partial sums leave it summed over the model
    axis."""
    if cut:
        return SH.leave(mlp(SH.enter(x), p))
    w1, w2 = p["w1"].to(x.dtype), p["w2"].to(x.dtype)
    if "w3" in p:
        return swiglu_tokens(x, w1, p["w3"].to(x.dtype), w2)
    return F.gelu(x @ w1, approximate="tanh") @ w2


def swiglu_tokens(
    x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """SwiGLU over the last axis."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2
