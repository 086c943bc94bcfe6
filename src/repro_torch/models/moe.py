"""Mixture-of-Experts FFN (Mixtral top-2; DeepSeek-V2's shared + routed).

The PyTorch counterpart of ``repro.models.moe``: GShard-style dense
dispatch. Tokens are grouped (one group per sequence, or ``moe_group``-token
chunks), each group dispatches into per-expert capacity slots through
one-hot products, the expert FFNs run as batched products over the expert
axis, and a combine product scatters the results back. Every shape is
static, so a step holds no host sync.

Capacity overflow drops tokens: their FFN output is 0 and the residual
passes. Slots go to the k routing choices in turn and, within a choice, to
tokens in order (a cumsum), so earlier tokens win capacity, as in GShard.

Router ties go to the lowest expert, as ``jax.lax.top_k`` breaks them: a
stable descending sort, then the first k (``torch.topk`` does not promise
an order among equal values).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.models.params import ParamSpec

F32 = torch.float32
# (token, choice) assignments routed and kept by capacity, summed since
# reset_routing_counts(); "kept" is a device tensor, so the count syncs
# nothing. launch.train reports the dropped share. ``moe_ffn`` counts each
# call; the model's full-sequence forward counts each layer once, outside
# ``torch.utils.checkpoint``, so a remat recompute adds nothing.
ROUTED: dict = {"choices": 0, "kept": 0}


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p: dict = {
        "router": ParamSpec((d, e), scale=d**-0.5),
        "w1": ParamSpec((e, d, f), scale=d**-0.5),
        "w3": ParamSpec((e, d, f), scale=d**-0.5),
        "w2": ParamSpec((e, f, d), scale=f**-0.5),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_specs(d, cfg.num_shared_experts * f)
    return p


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    c = int(
        group_tokens
        / cfg.num_experts
        * cfg.capacity_factor
        * cfg.experts_per_token
    )
    return max(4, -(-c // 4) * 4)  # >=4, rounded up to a multiple of 4


def _top_k_gates(logits: torch.Tensor, k: int, renormalize: bool):
    """logits [G,S,E] f32 -> (gates [G,S,K], expert idx [G,S,K] int64,
    probs [G,S,E]); equal probabilities go to the lowest expert."""
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    gates = probs.gather(-1, idx)
    if renormalize:  # Mixtral renormalizes the top-k; DeepSeek-V2 does not
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean one-hot by comparison (``F.one_hot`` checks its range on the
    host, a sync on the card)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _dispatch_combine(idx: torch.Tensor, gates: torch.Tensor, e: int, c: int):
    """-> dispatch [G,S,E,C] bool and combine [G,S,E,C] f32 one-hots.

    Slot assignment runs over the k routing choices, then over the token
    axis (cumsum): earlier tokens win capacity."""
    g, s, k = idx.shape
    counts = torch.zeros((g, 1, e), dtype=torch.int64, device=idx.device)
    disp = torch.zeros((g, s, e, c), dtype=torch.bool, device=idx.device)
    comb = torch.zeros((g, s, e, c), dtype=F32, device=idx.device)
    for j in range(k):  # k is small and static
        oh = _one_hot(idx[:, :, j], e).to(torch.int64)  # [G,S,E]
        pos = torch.cumsum(oh, dim=1) - oh + counts  # position within expert
        keep = (pos < c) & (oh > 0)
        slot = _one_hot(pos, c) & keep[..., None]
        disp = disp | slot
        comb = comb + gates[:, :, j, None, None] * slot.to(F32)
        counts = counts + oh.sum(dim=1, keepdim=True)
    return disp, comb


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, e: int):
    """Switch/GShard aux loss: E * sum_e fraction_e * mean_prob_e."""
    sel = _one_hot(idx, e).to(F32).sum(dim=-2)  # [G,S,E]
    frac = sel.mean(dim=(0, 1)) / max(idx.shape[-1], 1)
    mean_p = probs.mean(dim=(0, 1))
    return e * (frac * mean_p).sum()


def reset_routing_counts() -> None:
    ROUTED.update(choices=0, kept=0)


def count_routing(choices: int, kept: torch.Tensor) -> None:
    ROUTED["choices"] += choices
    ROUTED["kept"] = ROUTED["kept"] + kept


def dropped_share() -> Optional[float]:
    """The share of the choices routed since the last reset that capacity
    dropped (None when none were routed); reads the device count."""
    n = ROUTED["choices"]
    return 1.0 - float(ROUTED["kept"]) / n if n else None


def moe_ffn(
    x: torch.Tensor, p: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux loss, a scalar f32); the routing is
    counted in ``ROUTED``."""
    out, aux, routed = moe_ffn_routed(x, p, cfg)
    count_routing(*routed)
    return out, aux


def moe_ffn_routed(
    x: torch.Tensor, p: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, tuple[int, torch.Tensor]]:
    """``moe_ffn`` counting nothing: (out, aux, (choices routed, choices
    kept as a device tensor)) for the caller to count."""
    dt = x.dtype
    bsz, seq, d = x.shape
    gs = cfg.moe_group
    regroup = bool(gs) and seq % gs == 0 and seq > gs
    if regroup:  # GShard grouping: moe_group-token chunks
        x = x.reshape(bsz * (seq // gs), gs, d)
    g, s, _ = x.shape
    e, c = cfg.num_experts, capacity(cfg, s)

    # router logits in the compute dtype, then f32, as the JAX package
    # computes them: a bf16 run picks the experts the JAX one does
    logits = (x @ p["router"].to(dt)).to(F32)
    gates, idx, probs = _top_k_gates(logits, cfg.experts_per_token,
                                     cfg.route_norm)
    disp, comb = _dispatch_combine(idx, gates, e, c)
    aux = load_balance_loss(probs, idx, e)
    routed = (idx.numel(), disp.sum())

    # dispatch -> expert FFN (batched over the expert axis) -> combine
    xe = torch.einsum("gsec,gsd->egcd", disp.to(dt), x).reshape(e, g * c, d)
    h = F.silu(torch.bmm(xe, p["w1"].to(dt))) * torch.bmm(xe, p["w3"].to(dt))
    ye = torch.bmm(h, p["w2"].to(dt)).reshape(e, g, c, d)
    out = torch.einsum("gsec,egcd->gsd", comb.to(dt), ye)

    if cfg.num_shared_experts:
        out = out + mlp(x, p["shared"])
    if regroup:
        out = out.reshape(bsz, seq, d)
    return out, aux, routed


def routing_stats(logits: torch.Tensor, k: int) -> dict[str, torch.Tensor]:
    """Per-batch router statistics from the selection forward's logits:
    the mean entropy of the routing distribution and the mean top-1 prob."""
    probs = torch.softmax(logits.to(F32), dim=-1)
    top = torch.topk(probs, k, dim=-1).values
    return {
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(),
        "router_top1": top[..., 0].mean(),
    }
