"""Decoder-LM assembly for every family of the JAX package.

The PyTorch counterpart of ``repro.models.model``:

* dense / vlm / audio: [norm -> attention (GQA, or MLA) -> +res] [norm ->
  SwiGLU or GELU MLP -> +res] per layer (any group size, MHA to MQA;
  qk-norm optional); vlm and audio prepend a precomputed ``prefix``
  [B, P, D] of frame or patch embeddings (their frontends are stubs, as in
  the JAX package) and take the loss over the token positions only;
* moe:    the same with the MoE FFN (``models.moe``), after
  ``first_k_dense`` leading dense layers (``dense_blocks``) where set;
* ssm:    [norm -> Mamba2/SSD -> +res] per layer (mamba2-370m);
* hybrid: groups of ``hybrid_attn_every`` SSM layers, each group led by ONE
  weight-shared attention block with its own KV cache (zamba2-2.7b).

Layer parameters are stacked along leading dims exactly as in the JAX tree
(``blocks`` [L, ...], or [groups, every, ...] for the hybrid's SSM layers)
and run by Python loops over those dims.

Entry points: ``forward_hidden`` (full sequence, with the MoE aux loss
summed over the layers), ``per_example_loss`` / ``loss_fn`` (the OBFTF
loss signal, per-token CE through the cross-entropy kernel, plus
``router_aux_coef`` times the aux loss for MoE; the ssm and hybrid
families' scan differentiates through ``kernels.ops.ssd_scan``'s
hand-written backward), ``per_example_signals``
(CE, entropy and margin), ``prefill`` (full sequence, builds the decode
cache) and ``decode_step`` (one token per row against the dense or the
paged cache).

Over a data axis whose layout holds the params sliced (FSDP; the train
step runs under ``distributed.sharding.use_rules``), each layer gathers
its weights when it runs (``param_gather``, at the start of ``_block`` and
``_ssm_layer``, as the JAX ``_attn_block`` and ``_ssm_block`` do; the
hybrid's shared block once a use), inside the layer's checkpoint, so the
backward's recompute gathers again and no whole layer outlives its use;
the embedding, the head and the final norm are gathered where they are
used. The backward reduce-scatters the grads. With no rules (serving, one
device) every gather returns its input.

Over a model axis of M > 1 ranks (tensor parallelism, the dense, vlm and
audio families; the layout cuts what ``DEFAULT_RULES`` name ``model`` on
JAX's mesh) each block's attention runs on the rank's heads and its MLP on
the rank's columns (``layers.gqa_attend``/``mlp`` with a cut), the
embedding on the rank's vocab rows (out-of-slice tokens give zeros; the
rows are summed over the model axis), the head gives the rank's slice of
the logits, and the loss runs the cross-entropy kernel on that slice
(``_VocabXent``): the full-vocab logits are never gathered. The other
families raise there. ``activation_constraint`` marks the residual stream
where the JAX model does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import compat
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, tree_map

# families each entry point runs
SERVING_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
# the families whose training runs tensor-parallel over a model axis (GQA
# attention and a dense FFN; MLA's deepseek-v2-236b is not among them)
TENSOR_PARALLEL_FAMILIES = ("dense", "vlm", "audio")
TRAINING_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
# the families built of attention blocks alone, and those whose attention
# cache may be paged
ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")
PAGED_FAMILIES = ("dense", "vlm", "audio")


def _require(cfg: ModelConfig, families: tuple[str, ...], what: str) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"model family {cfg.family!r}: {what} is not ported to PyTorch "
            f"yet (ported for {', '.join(families)})"
        )


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def param_gather(p: dict, at: tuple) -> dict:
    """ZeRO-3 per-layer weight gather point (JAX ``model.param_gather``):
    ``p`` the params at path ``at`` of the tree, a layer's view of a stack
    or a block. No-op unless the active rules hold a layout that slices
    the params over a data axis of more than one rank."""
    return SH.param_gather_constraint(p, at)


def _whole(params: dict, key: str) -> torch.Tensor:
    """The top-level leaf ``key`` (embedding, head, final norm) whole:
    the plain gather JAX leaves to GSPMD."""
    return SH.gather_whole(params[key], (key,))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def stack_specs(tree, n: int):
    """Add a leading stacked-layers dim to every spec in the tree."""
    return tree_map(
        lambda _, s: ParamSpec((n, *s.shape), ("layers", *s.axes), s.init,
                               s.scale), tree
    )


def _attn_block_specs(cfg: ModelConfig, ffn: str = "dense") -> dict:
    d = cfg.d_model
    spec = {
        "attn_norm": L.rmsnorm_spec(d),
        "attn": (L.mla_specs(cfg) if cfg.attn_impl == "mla"
                 else L.gqa_specs(cfg)),
        "ffn_norm": L.rmsnorm_spec(d),
    }
    if ffn == "moe":
        spec["moe"] = MoE.moe_specs(cfg)
    else:
        spec["mlp"] = L.mlp_specs(d, cfg.d_ff, gelu=cfg.mlp_gelu)
    return spec


def _attn_stacks(cfg: ModelConfig) -> tuple[tuple[str, int], ...]:
    """(key, depth) of each stack of attention blocks, in layer order: the
    dense, vlm and audio families' ``blocks``; the moe family's
    ``first_k_dense`` leading dense layers (``dense_blocks``) where set,
    then its MoE ``blocks`` (of depth 0 where the depth is cut to
    ``first_k_dense``, as the JAX package scans an empty stack)."""
    if cfg.family != "moe":
        return (("blocks", cfg.num_layers),)
    lead = (("dense_blocks", cfg.first_k_dense),) if cfg.first_k_dense else ()
    return lead + (("blocks", cfg.num_layers - cfg.first_k_dense),)


def _ssm_block_specs(cfg: ModelConfig) -> dict:
    return {"norm": L.rmsnorm_spec(cfg.d_model), "ssm": S.ssm_specs(cfg)}


def param_specs(cfg: ModelConfig) -> dict:
    _require(cfg, SERVING_FAMILIES, "the parameter layout")
    d, v = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": L.rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((v, d), ("vocab", "embed"),
                                     scale=d**-0.5)
    if cfg.family in ATTN_FAMILIES:
        for key, n in _attn_stacks(cfg):
            ffn = "moe" if key == "blocks" and cfg.family == "moe" else "dense"
            specs[key] = stack_specs(_attn_block_specs(cfg, ffn), n)
    elif cfg.family == "ssm":
        specs["blocks"] = stack_specs(_ssm_block_specs(cfg), cfg.num_layers)
    else:  # hybrid: [groups, every, ...] SSM stacks, one shared attention
        inner = stack_specs(_ssm_block_specs(cfg), cfg.hybrid_attn_every)
        specs["blocks"] = stack_specs(inner, _groups(cfg))
        specs["shared_attn"] = _attn_block_specs(cfg)
    return specs


def _groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    return tree_map(lambda _, x: x[i], blocks)


# ---------------------------------------------------------------------------
# embedding / head / full-sequence forward
# ---------------------------------------------------------------------------


def tensor_parallel_refusal(cfg: ModelConfig, m: int) -> Optional[str]:
    """Why ``cfg`` does not train on a model axis of ``m`` ranks (None: it
    does). The port cuts the dense family's GQA blocks: not the other
    families, nor MLA, nor heads cut with their kv heads whole where a
    rank's q heads span a part of a kv group (``m`` neither divides nor is
    divided by the kv heads; no config at a power-of-two ``m``)."""
    if m == 1:
        return None
    if cfg.family not in TENSOR_PARALLEL_FAMILIES or cfg.attn_impl == "mla":
        return (f"{cfg.name} ({cfg.family}, {cfg.attn_impl}) has no tensor "
                f"parallelism in the port on a model axis of {m} (ROADMAP "
                "Queue 1 item 2: expert parallelism, the ssm and hybrid "
                "families, MLA)")
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h % m == 0 and kv % m and m % kv:
        return (f"{cfg.name}: {h} heads cut over a model axis of {m} with "
                f"its {kv} kv heads whole puts part of a kv group on a rank, "
                "which the port does not cut (ROADMAP Queue 1 item 2)")
    return None


def _require_model_axis(cfg: ModelConfig) -> None:
    """Raise where ``tensor_parallel_refusal`` refuses the active model
    axis."""
    why = tensor_parallel_refusal(cfg, SH.model_place()[1])
    if why is not None:
        raise NotImplementedError(why)


def _head_key(cfg: ModelConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


def embed_tokens(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor,
    prefix: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Row gather by ``index_select``, whose gradient is an ``index_add_``
    that reads nothing back to the host (an advanced-index gather's
    backward may, on CUDA); a ``prefix`` [B, P, D] goes in front, cast to
    the compute dtype. With the vocab cut over the model axis the rank
    gathers the rows of its slice, gives zeros for the other tokens, and
    the rows leave the region summed over the axis (one rank's are
    nonzero: the sum is exact); the backward adds into the slice's rows
    alone."""
    w = _whole(params, "embed").to(dtype_of(cfg.compute_dtype))
    ids = tokens.reshape(-1).long()
    if SH.model_cut(("embed",)):
        local = ids - SH.model_place()[0] * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = w.index_select(0, torch.where(inside, local, 0))
        x = SH.leave(torch.where(inside[:, None], rows, 0.0)).reshape(
            *tokens.shape, w.shape[1])
    else:
        x = w.index_select(0, ids).reshape(*tokens.shape, w.shape[1])
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The logits; with the vocab cut over the model axis, this rank's
    slice of them [..., V/M], ``x`` entering the region."""
    key = _head_key(cfg)
    w = _whole(params, key)
    if SH.model_cut((key,)):
        x = SH.enter(x)
    return x @ w.to(x.dtype).T


def _ffn(h, p, cfg, at=None):
    """The block's FFN -> (output, MoE aux loss, MoE routing count
    ``(choices, kept)``), the last two None for a dense FFN. Nothing is
    counted here. ``at``: the block's params path, whose MLP columns the
    model axis may cut."""
    if "moe" in p:
        return MoE.moe_ffn_routed(h, p["moe"], cfg)
    cut = at is not None and SH.model_cut(at + ("mlp", "w1"))
    return L.mlp(h, p["mlp"], cut), None, None


def _attend(h, p, cfg, positions, at=None):
    if cfg.attn_impl == "mla":
        return L.mla_attend(h, p, cfg, positions)
    cut = None
    if at is not None and SH.model_cut(at + ("attn", "wq")):
        cut = L.HeadCut(SH.model_place()[0],
                        SH.model_cut(at + ("attn", "wk")))
    return L.gqa_attend(h, p, cfg, positions, cut)


def _block(x, p, cfg, positions, at=("blocks",)):
    """One attention block; ``p`` the params at path ``at`` (a layer of the
    stack ``at``, or the hybrid's ``shared_attn``). Where the model axis
    cuts the block's heads or MLP columns they run on the rank's slice;
    heads it leaves whole (a count it does not divide) run replicated."""
    p = param_gather(p, at)
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + _attend(h, p["attn"], cfg, positions, at)
    out, aux, routed = _ffn(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), p,
                            cfg, at)
    return SH.activation_constraint(x + out, "residual"), aux, routed


def _ssm_layer(x, p, cfg):
    """One layer of the ssm family (or of a hybrid group): x +
    Mamba2(rmsnorm(x))."""
    p = param_gather(p, ("blocks",))
    return SH.activation_constraint(
        x + S.ssm_block(L.rmsnorm(x, p["norm"], cfg.norm_eps), p["ssm"],
                        cfg), "residual")


def _hybrid_group(x, shared, group, cfg, positions):
    """One group of the hybrid family: the weight-shared attention block,
    then the group's ``hybrid_attn_every`` SSM layers."""
    x, _, _ = _block(x, shared, cfg, positions, ("shared_attn",))
    for e in range(cfg.hybrid_attn_every):
        x = _ssm_layer(x, layer(group, e), cfg)
    return x


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``, its recompute under
    the forward's sharding rules (``recompute_context``)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=SH.recompute_context)


def _final_norm(x, params, cfg):
    return L.rmsnorm(x, _whole(params, "final_norm"), cfg.norm_eps)


def forward_hidden(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor,
    prefix: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] (after a ``prefix`` [B,P,D] where given) ->
    (final-normed hidden states [B,P+S,D], MoE aux loss summed over the
    MoE layers: an f32 scalar, 0 without MoE layers; the ssm family runs
    its Mamba2 layers; the hybrid family, for each of its
    ``num_layers / hybrid_attn_every`` groups, the ONE weight-shared
    ``shared_attn`` block and then the group's SSM layers, so the shared
    block's gradient is the sum of its uses, one a group).

    With ``cfg.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint``, as the JAX scan wraps its body in
    ``jax.checkpoint``: only layer inputs are kept for the backward, and
    the layer's aux loss comes out of the checkpoint with its output, so
    it keeps its gradient. So does the layer's routing count, which is
    added to ``moe.ROUTED`` here: the backward's recompute of the layer
    adds nothing. The hybrid family checkpoints each whole group, as the
    JAX outer scan does (its inner scan has no remat of its own): the
    backward recomputes one group at a time, the shared block's use in it
    included, so each SSM layer still runs its scan once a recompute. The
    model draws no random numbers, so no RNG state is stashed."""
    _require(cfg, TRAINING_FAMILIES, "the full-sequence forward")
    _require_model_axis(cfg)
    x = SH.activation_constraint(embed_tokens(params, cfg, tokens, prefix),
                                 "residual")
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            x = _remat(_ssm_layer, x, p, cfg) if remat else _ssm_layer(
                x, p, cfg)
        return _final_norm(x, params, cfg), aux
    if cfg.family == "hybrid":
        shared = params["shared_attn"]
        for g in range(_groups(cfg)):
            group = layer(params["blocks"], g)
            x = (_remat(_hybrid_group, x, shared, group, cfg, positions)
                 if remat else _hybrid_group(x, shared, group, cfg,
                                             positions))
        return _final_norm(x, params, cfg), aux
    for key, n in _attn_stacks(cfg):
        for i in range(n):
            p = layer(params[key], i)
            if remat:
                x, a, routed = _remat(_block, x, p, cfg, positions, (key,))
            else:
                x, a, routed = _block(x, p, cfg, positions, (key,))
            if a is not None:
                aux = aux + a
                MoE.count_routing(*routed)
    return _final_norm(x, params, cfg), aux


class _VocabXent(torch.autograd.Function):
    """Cross-entropy over a vocab cut into the model axis's slices, from
    this rank's slice of the logits [T, V/M] (rows ``[offset, offset +
    V/M)`` of the vocab): ``kops.xent_fwd`` on the slice with the labels
    shifted by ``offset`` (a label outside the slice picks nothing: loss =
    lse), each rank's (lse, picked logit) all-gathered over the axis, the
    global lse their logsumexp and the picked logit their sum, in rank
    order, so every model rank holds the same bits. The backward is
    ``kops.xent_bwd`` on the slice with the global lse: exactly this
    slice's part of the full gradient, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, offset):
        local = labels - offset
        loss, lse = kops.xent_fwd(logits, local)
        both = compat.all_gather(torch.stack([lse, lse - loss])[None],
                                 compat.MODEL)  # [M, 2, T]
        glse = torch.logsumexp(both[:, 0], dim=0)
        ctx.save_for_backward(logits, local, glse)
        return glse - both[:, 1].sum(0)

    @staticmethod
    def backward(ctx, g):
        logits, local, glse = ctx.saved_tensors
        return kops.xent_bwd(logits, local, glse, g), None, None


def per_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                   vocab_cut: bool = False) -> torch.Tensor:
    """Cross-entropy per token through ``kernels.ops.xent_loss`` (the CUDA
    kernel on the card), masked afterwards: labels < 0 give 0, as in the JAX
    model (the kernel itself gives lse there). [B,S,V], [B,S] -> [B,S] f32.
    With ``vocab_cut`` the logits are this rank's slice of the vocab
    (``unembed`` under a model axis): ``_VocabXent``, the same kernels."""
    v = logits.shape[-1]
    if vocab_cut:
        loss = _VocabXent.apply(logits.reshape(-1, v), labels.reshape(-1),
                                SH.model_place()[0] * v)
    else:
        loss = kops.xent_loss(logits.reshape(-1, v), labels.reshape(-1))
    return torch.where(labels >= 0, loss.reshape(labels.shape), 0.0)


def _token_hidden(params, cfg, batch):
    """``forward_hidden`` over the batch's prefix (``prefix_embed``, where
    given) and tokens -> (the token positions' hidden states, aux)."""
    prefix = batch.get("prefix_embed")
    hidden, aux = forward_hidden(params, cfg, batch["tokens"], prefix)
    if prefix is not None:
        hidden = hidden[:, prefix.shape[1]:]
    return hidden, aux


def _tied_whole(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with a tied table gathered once for both its uses (the
    embedding and the head then find it whole)."""
    if not cfg.tie_embeddings:
        return params
    return dict(params, embed=_whole(params, "embed"))


def per_example_loss(
    params: dict, cfg: ModelConfig, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (per-example mean CE [B] over the label positions, the MoE aux
    loss). The OBFTF loss signal. A batch's ``prefix_embed`` [B, P, D]
    goes in front of the tokens, and the loss is over the token positions
    only."""
    params = _tied_whole(params, cfg)
    hidden, aux = _token_hidden(params, cfg, batch)
    ce = per_token_loss(unembed(params, cfg, hidden), batch["labels"],
                        SH.model_cut((_head_key(cfg),)))
    denom = torch.clamp((batch["labels"] >= 0).sum(dim=-1), min=1)
    return ce.sum(dim=-1) / denom.to(torch.float32), aux


def per_example_signals(
    params: dict, cfg: ModelConfig, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor], torch.Tensor]:
    """-> (per-example CE [B], {"entropy", "margin"} [B], aux loss).

    The train-side twin of the serving recorder's signal derivation: CE
    through :func:`per_token_loss` (the cross-entropy kernel, whose
    backward runs under autograd) on f32 logits, per-token predictive
    entropy ``lse - sum(softmax * logits)`` and the top-1 minus top-2
    logit margin, each a masked mean over the label positions in f32. The
    two signals come from detached logits: they are read, never
    differentiated. ``aux`` is the MoE aux loss (0 without MoE layers);
    a ``prefix_embed`` is read as ``per_example_loss`` reads it."""
    if SH.model_cut((_head_key(cfg),)):
        raise NotImplementedError(
            "per_example_signals on a vocab cut over the model axis: the "
            "entropy and margin need the whole row (ROADMAP Queue 1 item 2)")
    params = _tied_whole(params, cfg)
    hidden, aux = _token_hidden(params, cfg, batch)
    logits = unembed(params, cfg, hidden).to(torch.float32)
    labels = batch["labels"]
    ce = per_token_loss(logits, labels)
    with torch.no_grad():
        lg = logits.detach()
        lse = torch.logsumexp(lg, dim=-1)
        ent = lse - (torch.softmax(lg, dim=-1) * lg).sum(dim=-1)
        top2 = torch.topk(lg, 2, dim=-1).values
        mar = top2[..., 0] - top2[..., 1]
        mask = (labels >= 0).to(torch.float32)
        denom = torch.clamp(mask.sum(dim=-1), min=1.0)
        signals = {"entropy": (ent * mask).sum(dim=-1) / denom,
                   "margin": (mar * mask).sum(dim=-1) / denom}
    return ce.sum(dim=-1) / denom, signals, aux


def loss_fn(
    cfg: ModelConfig,
) -> Callable[[dict, dict[str, torch.Tensor]], torch.Tensor]:
    """``per_example_loss_fn(params, batch) -> [B]`` for the OBFTF step.

    The MoE aux load-balancing loss is folded into every example's loss (a
    scalar shared across the batch: the gradient of the mean keeps it
    once), so the losses the step records include it, as in the JAX
    package."""
    _require(cfg, TRAINING_FAMILIES, "the training loss")

    def fn(params: dict, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        losses, aux = per_example_loss(params, cfg, batch)
        if cfg.uses_moe:
            losses = losses + cfg.router_aux_coef * aux
        return losses

    return fn


# ---------------------------------------------------------------------------
# caches / prefill / decode
# ---------------------------------------------------------------------------


def _stack_over(n: int, one: dict) -> dict:
    """A cache dict with a leading dim of ``n`` zeroed copies."""
    return {k: v.new_zeros((n, *v.shape)) for k, v in one.items()}


def _attn_init_cache(cfg, batch, max_seq, dtype, device) -> dict:
    if cfg.attn_impl == "mla":
        return L.mla_init_cache(cfg, batch, max_seq, dtype, device)
    return L.gqa_init_cache(cfg, batch, max_seq, dtype, device)


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, device: torch.device | str
) -> dict:
    """Decode cache with a batch dim of ``batch`` rows.

    dense, vlm, audio: ``blocks`` K/V [L, B, T, kv, hd] (T =
    ``gqa_cache_len``; int8 K/V with f32 scales [L, B, T, kv]), or with
    MLA the latent ``ckv`` [L, B, T, R] and ``kpe`` [L, B, T, pe]; moe:
    the same for its MoE ``blocks`` and, with ``first_k_dense``, its
    ``dense_blocks``; ssm:
    ``blocks`` state [L, B, H, P, N] f32 and conv [L, B, K-1, C]; hybrid:
    ``blocks`` [groups, every, B, ...] and ``shared_attn`` K/V
    [groups, B, T, kv, hd], one cache per group though the groups share
    their attention weights."""
    _require(cfg, SERVING_FAMILIES, "the decode cache")
    dt = dtype_of(cfg.compute_dtype)
    if cfg.family in ATTN_FAMILIES:
        one = _attn_init_cache(cfg, batch, max_seq, dt, device)
        return {key: _stack_over(n, one) for key, n in _attn_stacks(cfg)}
    ssm = S.ssm_init_cache(cfg, batch, dt, device)
    if cfg.family == "ssm":
        return {"blocks": _stack_over(cfg.num_layers, ssm)}
    attn = L.gqa_init_cache(cfg, batch, max_seq, dt, device)
    return {
        "blocks": _stack_over(_groups(cfg),
                              _stack_over(cfg.hybrid_attn_every, ssm)),
        "shared_attn": _stack_over(_groups(cfg), attn),
    }


def init_paged_cache(
    cfg: ModelConfig, num_pages: int, page_size: int,
    device: torch.device | str,
) -> dict:
    """Global paged KV pool, stacked over layers: [L, P, page, kv, hd]. A
    physical page id addresses the same page in every layer, so one table
    per row serves the whole stack. Only plain-GQA caches of the dense,
    vlm and audio families are paged: recurrent state, the hybrid's shared
    block, MoE capacity, latent (MLA) caches, rolling windows and int8 K/V
    keep the dense layout, as in the JAX package."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged KV cache: family {cfg.family!r} has non-KV or "
            "capacity-coupled cache state")
    if cfg.attn_impl == "mla":
        raise NotImplementedError(
            "paged KV cache requires plain GQA without a sliding window")
    dt = dtype_of(cfg.compute_dtype)
    one = L.gqa_paged_init_cache(cfg, num_pages, page_size, dt, device)
    return {"blocks": _stack_over(cfg.num_layers, one)}


def _stack_caches(caches: list[dict]) -> dict:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _attn_block_fill(x, p, cfg, positions, max_seq):
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    fill = L.mla_fill_cache if cfg.attn_impl == "mla" else L.gqa_fill_cache
    a, cache = fill(h, p["attn"], cfg, positions, max_seq)
    x = x + a
    out, _, _ = _ffn(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), p, cfg)
    return SH.activation_constraint(x + out, "residual"), cache


def _ssm_block_fill(x, p, cfg):
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    out, cache = S.ssm_fill_cache(h, p["ssm"], cfg)
    return SH.activation_constraint(x + out, "residual"), cache


def prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    max_seq: int,
    prefix: Optional[torch.Tensor] = None,
    last_pos: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward building the decode cache.

    Returns (logits [B,V] at the last position, or at ``last_pos[b]`` for
    right-padded prompts, and the cache in :func:`init_cache`'s layout).
    A ``prefix`` [B,P,D] goes in front of the tokens and takes the cache's
    first P positions; ``last_pos`` counts them.
    """
    _require(cfg, SERVING_FAMILIES, "prefill")
    x = SH.activation_constraint(embed_tokens(params, cfg, tokens, prefix),
                                 "residual")
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family in ATTN_FAMILIES:
        cache = {}
        for key, n in _attn_stacks(cfg):
            caches = []
            for i in range(n):
                x, c = _attn_block_fill(x, layer(params[key], i), cfg,
                                        positions, max_seq)
                caches.append(c)
            cache[key] = _stack_caches(caches) if n else _stack_over(
                0, _attn_init_cache(cfg, x.shape[0], max_seq, x.dtype,
                                    x.device))
    elif cfg.family == "ssm":
        caches = []
        for i in range(cfg.num_layers):
            x, c = _ssm_block_fill(x, layer(params["blocks"], i), cfg)
            caches.append(c)
        cache = {"blocks": _stack_caches(caches)}
    else:
        shared = params["shared_attn"]
        attn_caches, group_caches = [], []
        for gi in range(_groups(cfg)):
            x, ac = _attn_block_fill(x, shared, cfg, positions, max_seq)
            attn_caches.append(ac)
            group = layer(params["blocks"], gi)
            inner = []
            for e in range(cfg.hybrid_attn_every):
                x, c = _ssm_block_fill(x, layer(group, e), cfg)
                inner.append(c)
            group_caches.append(_stack_caches(inner))
        cache = {"blocks": _stack_caches(group_caches),
                 "shared_attn": _stack_caches(attn_caches)}
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_pos is None:
        last = x[:, -1:]
    else:
        bidx = torch.arange(x.shape[0], device=x.device)
        last = x[bidx, last_pos.long()][:, None]
    logits = unembed(params, cfg, last)[:, 0]
    return logits, cache


def _attn_block_decode(x, p, cfg, c, pos, page_table=None):
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if page_table is not None:
        a, _ = L.gqa_paged_decode(h, p["attn"], cfg, c, page_table, pos)
    elif cfg.attn_impl == "mla":
        a, _ = L.mla_decode(h, p["attn"], cfg, c, pos, c["ckv"].shape[1])
    else:
        a, _ = L.gqa_decode(h, p["attn"], cfg, c, pos, c["k"].shape[1])
    x = x + a
    out, _, _ = _ffn(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), p, cfg)
    return x + out


def _ssm_block_decode(x, p, cfg, c):
    """The block's output; the layer's (state, conv) cache ``c`` (views
    into the stacked cache) is overwritten in place."""
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    out, new = S.ssm_decode(h, p["ssm"], cfg, c)
    c["state"].copy_(new["state"])
    c["conv"].copy_(new["conv"])
    return x + out


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
    vector (the SSM recurrence ignores it). ``page_table`` ([B, NP] i32,
    -1 = unallocated) switches the dense, vlm and audio families to the
    paged pool of :func:`init_paged_cache`. The cache is updated in place
    and returned.
    """
    _require(cfg, SERVING_FAMILIES, "decode")
    if page_table is not None and cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged decode: unsupported family {cfg.family!r}")
    x = embed_tokens(params, cfg, tokens)
    blocks = cache["blocks"]
    if cfg.family in ATTN_FAMILIES:
        for key, n in _attn_stacks(cfg):
            for i in range(n):
                x = _attn_block_decode(x, layer(params[key], i), cfg,
                                       layer(cache[key], i), pos, page_table)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssm_block_decode(x, layer(params["blocks"], i), cfg,
                                  layer(blocks, i))
    else:
        shared = params["shared_attn"]
        for gi in range(_groups(cfg)):
            x = _attn_block_decode(x, shared, cfg,
                                   layer(cache["shared_attn"], gi), pos)
            group, group_cache = layer(params["blocks"], gi), layer(blocks, gi)
            for e in range(cfg.hybrid_attn_every):
                x = _ssm_block_decode(x, layer(group, e), cfg,
                                      layer(group_cache, e))
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x)[:, 0], cache


def greedy_token(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    del cfg
    return torch.argmax(logits, dim=-1).to(torch.int32)
