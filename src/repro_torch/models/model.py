"""Decoder-LM assembly for the dense family.

The PyTorch counterpart of ``repro.models.model`` for ``family="dense"``:
[norm -> GQA attention -> +res] [norm -> SwiGLU -> +res] per layer, the
layers' parameters stacked along a leading dim (``blocks``) exactly as in
the JAX tree, run by a Python loop over that dim.

Entry points: ``forward_hidden`` (full sequence), ``per_example_loss`` /
``loss_fn`` (the OBFTF loss signal, per-token CE through the cross-entropy
kernel), ``prefill`` (full sequence, builds the decode cache) and
``decode_step`` (one token per row against the dense or the paged cache).
Other families raise ``NotImplementedError`` naming themselves.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, tree_map

PORTED_FAMILIES = ("dense",)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to PyTorch yet"
        )


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def stack_specs(tree, n: int):
    """Add a leading stacked-layers dim to every spec in the tree."""
    return tree_map(
        lambda _, s: ParamSpec((n, *s.shape), s.init, s.scale), tree
    )


def param_specs(cfg: ModelConfig) -> dict:
    _require_dense(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": ParamSpec((v, d), scale=0.02),
        "final_norm": L.rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((v, d), scale=d**-0.5)
    block = {
        "attn_norm": L.rmsnorm_spec(d),
        "attn": L.gqa_specs(cfg),
        "ffn_norm": L.rmsnorm_spec(d),
        "mlp": L.mlp_specs(d, cfg.d_ff, gelu=cfg.mlp_gelu),
    }
    specs["blocks"] = stack_specs(block, cfg.num_layers)
    return specs


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    return tree_map(lambda _, x: x[i], blocks)


# ---------------------------------------------------------------------------
# embedding / head / full-sequence forward
# ---------------------------------------------------------------------------


def embed_tokens(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor
) -> torch.Tensor:
    """Row gather by ``index_select``, whose gradient is an ``index_add_``
    that reads nothing back to the host (an advanced-index gather's
    backward may, on CUDA)."""
    w = params["embed"].to(dtype_of(cfg.compute_dtype))
    return w.index_select(0, tokens.reshape(-1).long()).reshape(
        *tokens.shape, w.shape[1])


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x @ w.to(x.dtype).T


def _block(x, p, cfg, positions):
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + L.gqa_attend(h, p["attn"], cfg, positions)
    h = L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
    return x + L.mlp(h, p["mlp"])


def forward_hidden(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor
) -> torch.Tensor:
    """tokens [B,S] -> final-normed hidden states [B,S,D].

    With ``cfg.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint``, as the JAX scan wraps its body in
    ``jax.checkpoint``: only layer inputs are kept for the backward. The
    model draws no random numbers, so no RNG state is stashed."""
    _require_dense(cfg)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block, x, p, cfg, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, p, cfg, positions)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def per_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy per token through ``kernels.ops.xent_loss`` (the CUDA
    kernel on the card), masked afterwards: labels < 0 give 0, as in the JAX
    model (the kernel itself gives lse there). [B,S,V], [B,S] -> [B,S] f32."""
    v = logits.shape[-1]
    loss = kops.xent_loss(logits.reshape(-1, v), labels.reshape(-1))
    return torch.where(labels >= 0, loss.reshape(labels.shape), 0.0)


def per_example_loss(
    params: dict, cfg: ModelConfig, batch: dict[str, torch.Tensor]
) -> torch.Tensor:
    """-> per-example mean CE [B] over the label positions (the OBFTF loss
    signal)."""
    hidden = forward_hidden(params, cfg, batch["tokens"])
    ce = per_token_loss(unembed(params, cfg, hidden), batch["labels"])
    denom = torch.clamp((batch["labels"] >= 0).sum(dim=-1), min=1)
    return ce.sum(dim=-1) / denom.to(torch.float32)


def loss_fn(
    cfg: ModelConfig,
) -> Callable[[dict, dict[str, torch.Tensor]], torch.Tensor]:
    """``per_example_loss_fn(params, batch) -> [B]`` for the OBFTF step
    (the dense family has no MoE aux loss to fold in)."""
    _require_dense(cfg)

    def fn(params: dict, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return per_example_loss(params, cfg, batch)

    return fn


# ---------------------------------------------------------------------------
# caches / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, device: torch.device | str
) -> dict:
    """Dense per-row KV cache, stacked over layers: [L, B, T, kv, hd]."""
    _require_dense(cfg)
    dt = dtype_of(cfg.compute_dtype)
    one = L.gqa_init_cache(cfg, batch, max_seq, dt, device)
    return {"blocks": {k: v.new_zeros((cfg.num_layers, *v.shape))
                       for k, v in one.items()}}


def init_paged_cache(
    cfg: ModelConfig, num_pages: int, page_size: int,
    device: torch.device | str,
) -> dict:
    """Global paged KV pool, stacked over layers: [L, P, page, kv, hd]. A
    physical page id addresses the same page in every layer, so one table
    per row serves the whole stack."""
    _require_dense(cfg)
    dt = dtype_of(cfg.compute_dtype)
    one = L.gqa_paged_init_cache(cfg, num_pages, page_size, dt, device)
    return {"blocks": {k: v.new_zeros((cfg.num_layers, *v.shape))
                       for k, v in one.items()}}


def prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    max_seq: int,
    last_pos: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward building the dense decode cache.

    Returns (logits [B,V] at the last position, or at ``last_pos[b]`` for
    right-padded prompts, and the cache [L, B, max_seq, kv, hd]).
    """
    _require_dense(cfg)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        a, c = L.gqa_fill_cache(h, p["attn"], cfg, positions, max_seq)
        x = x + a
        h = L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
        x = x + L.mlp(h, p["mlp"])
        ks.append(c["k"])
        vs.append(c["v"])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_pos is None:
        last = x[:, -1:]
    else:
        bidx = torch.arange(x.shape[0], device=x.device)
        last = x[bidx, last_pos.long()][:, None]
    logits = unembed(params, cfg, last)[:, 0]
    return logits, {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(
    params: dict,
    cfg: ModelConfig,
    cache: dict,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    page_table: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B,1] -> (logits [B,V], cache).

    ``pos`` is the number of tokens already cached: a scalar or a [B]
    vector. ``page_table`` ([B, NP] i32, -1 = unallocated) switches to the
    paged pool of :func:`init_paged_cache`. The cache is updated in place
    and returned.
    """
    _require_dense(cfg)
    x = embed_tokens(params, cfg, tokens)
    blocks = cache["blocks"]
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        c = layer(blocks, i)
        h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if page_table is not None:
            a, _ = L.gqa_paged_decode(h, p["attn"], cfg, c, page_table, pos)
        else:
            a, _ = L.gqa_decode(h, p["attn"], cfg, c, pos, c["k"].shape[1])
        x = x + a
        h = L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
        x = x + L.mlp(h, p["mlp"])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x)[:, 0], cache


def greedy_token(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    del cfg
    return torch.argmax(logits, dim=-1).to(torch.int32)
