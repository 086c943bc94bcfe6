"""Logical-axis placement tables (the MaxText pattern), without JAX.

The port's counterpart of ``repro.distributed.sharding`` (its lines
40-176). Parameters declare *logical* axes (``models.params.ParamSpec``'s
``axes``: "embed", "heads", "experts", ...); a rule table maps logical axes
to mesh axes. ``param_partition_specs`` applies the table with a
divisibility filter: a mesh axis is dropped (the dim replicated) where the
dim does not divide by it, and a mesh axis appears at most once in a spec,
so one table serves kv=1 MQA, 8-expert and 160-expert models alike; per-arch
``shard_overrides`` tune the exceptions (``rules_for``).

A partition spec here is a plain tuple with one entry per dim: None
(replicated), a mesh axis name, or a tuple of names. The mesh is anything
with a ``shape`` dict (``launch.mesh.Mesh.shape`` is ``{"data": D,
"model": M}``), as the JAX ``spec_for`` reads only ``mesh.shape``.

What the port places with these tables (``distributed.zero``): the
params over the model axis and over the data axis where their spec names
them (tensor parallelism and FSDP, as the JAX trainer's
``state_specs``), and the ZeRO-1 optimizer moments.

The parameter hooks of the JAX module's lines 181-280 are ported:
``set_rules`` and ``use_rules`` (a thread-local context, which here also
holds the rank's param layout, a ``zero.DataLayout``), and
``param_gather_constraint``, the ZeRO-3 gather point that each layer calls
on its params (``models.model.param_gather``): it all-gathers the leaves
the layout holds sliced, through an autograd function whose backward
reduce-scatters their grads. JAX with ``gather_params=False`` leaves these
collectives to GSPMD, which the port does not have, so the port always
gathers: the values are the same. ``gather_whole`` is that plain gather
for the leaves outside the layers (the embedding, the head and the final
norm), which JAX leaves to GSPMD.

The int8 gather follows JAX's rule: with ``gather_params`` and
``int8_gather`` both set (``dataclasses.replace(FSDP_RULES,
int8_gather=True)``, as the JAX ``dryrun`` builds its int8 strategy),
every leaf of a layer's tree comes quantized per chunk of its flattened
values (``_int8_zero3_gather``, JAX's values): a sliced leaf's int8 and
scales are gathered, a leaf held whole is quantized where it is, which
gives the same values since JAX's pieces are aligned to the chunks.
``recompute_context`` carries the rules into a checkpointed layer's
recompute, which autograd may run on another thread.

The model axis (tensor parallelism of the dense family, as GSPMD places
``DEFAULT_RULES``' heads, kv heads, MLP columns and vocab rows): a leaf
whose spec names ``model`` is held as this rank's model slice for good
(``zero.DataLayout.model_dim_at``; ``model_cut`` reads it from the active
layout), and the model code runs each tensor-parallel region between two
operations on ``compat``'s model axis, ``enter`` (identity forward, sum
over the model axis backward) and ``leave`` (sum forward, identity
backward). The rule for a leaf the model axis leaves whole (a norm): its
grad must be summed over the model axis exactly where it is used inside a
region, on cut heads (``q_norm``; ``k_norm`` where the kv heads are cut),
and never where it is used before the entry (``attn_norm``,
``ffn_norm``, ``final_norm``, and ``wk``, ``wv``, ``k_norm`` where the kv
heads are whole), whose grad is whole on every model rank already. So
each replicated tensor goes through ``enter`` once, where it first meets
cut compute: the activation before the cut projections, the whole k and v
before the kv heads a rank's q heads use are picked, and a norm's weight
itself where it acts on cut heads.

``activation_constraint`` is JAX's hook for the residual stream. It is
the identity while the rules' ``seq_axis`` is None (``DEFAULT_RULES``);
sequence parallelism is not ported: rules with a ``seq_axis`` raise.

Not ported: ``ulysses_constraint``, ``cp_kv_gather`` (the JAX module's
lines 281-356) and the ``ulysses`` field, with sequence parallelism.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Union

import torch

from repro_torch.distributed import compat
from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.models.params import ParamSpec, tree_at, tree_map

MeshAxes = Optional[Union[tuple[str, ...], str]]
PartitionSpec = tuple  # one MeshAxes entry per dim


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis -> mesh axis (or tuple of axes) mapping."""

    rules: dict[Optional[str], MeshAxes]
    batch_axes: tuple[str, ...] = ("data",)
    seq_axis: Optional[str] = None  # sequence-parallel residual stream
    model_axis: Optional[str] = "model"
    # ZeRO-3: JAX forces the per-layer weight all-gather with it, instead
    # of letting GSPMD all-reduce partial-sum activations. The port always
    # gathers (no GSPMD); here, as in JAX, it gates ``int8_gather``
    gather_params: bool = False
    # quantize the ZeRO-3 weight gathers to int8 (wire bytes halve)
    int8_gather: bool = False

    def lookup(self, logical: Optional[str]) -> MeshAxes:
        return self.rules.get(logical, None)


DEFAULT_RULES = AxisRules(
    rules={
        "vocab": "model",
        "embed": "data",  # FSDP
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",  # expert parallelism
        "expert_mlp": "data",  # FSDP inside each expert
        "q_lora": None,
        "kv_lora": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv": None,
        "layers": None,
        "blocks": None,
        None: None,
    },
    batch_axes=("data",),
)


# Pure-FSDP placement: parameters sharded over both mesh axes, no tensor
# parallelism, batch over both axes.
FSDP_RULES = AxisRules(
    rules={
        "vocab": None,
        "embed": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": None,
        "experts": "model",  # MoE keeps expert parallelism
        "expert_mlp": "data",
        "q_lora": None,
        "kv_lora": None,
        "ssm_inner": None,
        "ssm_heads": None,
        "ssm_state": None,
        "conv": None,
        "layers": None,
        "blocks": None,
        None: None,
    },
    batch_axes=("data", "model"),
    gather_params=True,
)


def rules_for(cfg, rules: AxisRules) -> AxisRules:
    """Apply a ModelConfig's per-arch ``shard_overrides`` to a rule table."""
    overrides = dict(getattr(cfg, "shard_overrides", ()) or ())
    if not overrides:
        return rules
    merged = dict(rules.rules)
    merged.update(overrides)
    return dataclasses.replace(rules, rules=merged)


def axis_names(axes: MeshAxes) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (() for None)."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes: MeshAxes) -> int:
    n = 1
    for a in axis_names(axes):
        n *= mesh.shape[a]
    return n


def spec_for(spec: ParamSpec, rules: AxisRules, mesh) -> PartitionSpec:
    """Partition spec of one param, with per-dim divisibility filtering."""
    parts = []
    used: set[str] = set()
    for dim, logical in zip(spec.shape, spec.axes):
        axes = rules.lookup(logical)
        if axes is not None and mesh is not None:
            if dim % _axis_size(mesh, axes) != 0:
                axes = None  # replicate instead of an uneven shard
        if axes is not None:
            flat = axis_names(axes)
            if any(a in used for a in flat):
                axes = None  # a mesh axis may appear once per spec
            else:
                used.update(flat)
        parts.append(axes)
    return tuple(parts)


def param_partition_specs(
    specs: Any, rules: AxisRules = DEFAULT_RULES, mesh=None
) -> Any:
    return tree_map(lambda _, s: spec_for(s, rules, mesh), specs)


def batch_spec(rules: AxisRules, extra_pod: Optional[str] = None
               ) -> PartitionSpec:
    axes = (rules.batch_axes if extra_pod is None
            else (extra_pod, *rules.batch_axes))
    # one axis is named bare, as JAX's PartitionSpec normalizes it
    return (axes[0] if len(axes) == 1 else tuple(axes),)


# ---------------------------------------------------------------------------
# the parameter gather (context-scoped so model code is mesh-agnostic)
# ---------------------------------------------------------------------------

_ctx = threading.local()
INT8_CHUNK = 256  # the int8 gather's chunk (JAX's default)


def set_rules(mesh, rules: Optional[AxisRules], layout=None) -> None:
    """Make ``mesh``, ``rules`` and this rank's param ``layout`` (a
    ``zero.DataLayout``) the current thread's context."""
    _ctx.mesh = mesh
    _ctx.rules = rules
    _ctx.layout = layout


def _current() -> tuple:
    return (getattr(_ctx, "mesh", None), getattr(_ctx, "rules", None),
            getattr(_ctx, "layout", None))


class use_rules:
    """Context manager: ``set_rules(mesh, rules, layout)`` inside, the
    previous context put back on the way out (an exception included)."""

    def __init__(self, mesh, rules: Optional[AxisRules], layout=None):
        self.rules = (mesh, rules, layout)

    def __enter__(self):
        self.prev = _current()
        set_rules(*self.rules)

    def __exit__(self, *exc):
        set_rules(*self.prev)


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant): the
    forward's context put back around the backward's recompute of the
    layer, which autograd runs on its device thread for CUDA tensors,
    where this thread's context is not set."""
    return contextlib.nullcontext(), use_rules(*_current())


def _sliced_layout():
    """The active layout, where it holds params sliced over more than one
    rank; else None."""
    _, _, layout = _current()
    if layout is None or layout.shards == 1:
        return None
    return layout


class _Gather(torch.autograd.Function):
    """All-gather each tensor along its dim (one collective a dtype); the
    backward reduce-scatters the grads back to this rank's slices."""

    @staticmethod
    def forward(ctx, dims, *xs):
        ctx.dims = dims
        return tuple(compat.all_gather_along(list(xs), list(dims)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *compat.reduce_scatter_along(list(grads),
                                                   list(ctx.dims)))


def _gather(tree: Any, at: tuple, layout, int8: bool) -> Any:
    """Every leaf of ``tree`` (the params at path ``at``, or a part of
    them, with any number of leading stacked dims indexed away) that
    ``layout`` holds sliced, gathered whole; the others as they are. With
    ``int8``, every leaf quantized: the sliced ones through the int8
    gather, the others where they are."""
    picks: list = []  # (path under tree, dim in the leaf; None: whole)

    def visit(path, x):
        full = at + path
        if layout is None or layout.shards == 1 or not layout.held_at(full):
            if int8:
                picks.append((path, None))
            return
        shape, cut = layout.shape_at(full), layout.dim_at(full)
        d = cut - len(shape) + x.dim()
        if x.shape[d] == shape[cut]:
            return  # already whole (a tied table gathered for two uses)
        if x.shape[d] * layout.shards != shape[cut]:
            raise ValueError(f"param {'/'.join(full)} of shape "
                             f"{tuple(x.shape)} is neither this rank's "
                             f"slice of {shape} nor whole")
        picks.append((path, d))

    tree_map(visit, tree)
    if not picks:
        return tree
    if layout is not None and layout.shards > 1:
        compat.expect(compat.DATA, layout.shards, layout.rank)
    leaves = [tree_at(tree, p) for p, _ in picks]
    if int8:
        out = [_Int8Gather.apply(x, d, INT8_CHUNK)
               for x, (_, d) in zip(leaves, picks)]
    else:
        out = _Gather.apply(tuple(d for _, d in picks), *leaves)
    done = {p: y for (p, _), y in zip(picks, out)}
    return tree_map(lambda p, x: done.get(p, x), tree)


def param_gather_constraint(tree: Any, at: tuple = ()) -> Any:
    """ZeRO-3 gather point: inside a layer body, the layer's params (the
    subtree at path ``at`` of the params, a stacked layer's view or a
    block) gathered whole from every rank's slices, where the active
    layout holds them sliced; the backward reduce-scatters their grads.

    With ``rules.gather_params`` and ``rules.int8_gather`` (JAX's gate)
    every leaf of ``tree`` comes int8-quantized (``_int8_zero3_gather``),
    as JAX's do, on any number of ranks. Otherwise it returns ``tree``
    itself with no context, or with a data axis of one: no collective."""
    mesh, rules, layout = _current()
    if mesh is None or rules is None:
        return tree
    int8 = rules.gather_params and rules.int8_gather
    if not int8 and _sliced_layout() is None:
        return tree
    return _gather(tree, at, layout, int8)


def gather_whole(tree: Any, at: tuple = ()) -> Any:
    """The plain gather of ``param_gather_constraint`` for the params
    outside the layers (embedding, head, final norm), which the JAX
    package leaves to GSPMD: never int8."""
    layout = _sliced_layout()
    return tree if layout is None else _gather(tree, at, layout, False)


def _int8_pieces(x: torch.Tensor, dim: int, chunk: int) -> tuple:
    """This rank's contiguous 1/S of the whole leaf flattened row-major and
    zero-padded to a multiple of ``S * chunk`` (JAX's flat shard), from
    every rank's slices along ``dim``: one uneven ``all_to_all`` that moves
    each element once -> (piece [m], whole shape)."""
    size, rank = compat.axis_size(), compat.linear_axis_index()
    shape = list(x.shape)
    k = shape[dim]
    whole = shape[:dim] + [k * size] + shape[dim + 1:]
    inner = 1
    for s in shape[dim + 1:]:
        inner *= s
    n = x.numel() * size
    m = -(-n // (size * chunk)) * chunk
    blk, row = k * inner, size * k * inner  # a rank's run in a row; a row

    def before(i: int, f: int) -> int:
        """Elements of rank i's slice whose flat index is below f."""
        a, rem = divmod(min(f, n), row)
        return a * blk + min(max(rem - i * blk, 0), blk)

    send = [before(rank, (j + 1) * m) - before(rank, j * m)
            for j in range(size)]
    recv = [before(i, (rank + 1) * m) - before(i, rank * m)
            for i in range(size)]
    got = list(torch.split(compat.all_to_all(x.reshape(-1), send, recv),
                           recv))
    used = [0] * size
    parts = []

    def take(i: int, count: int) -> torch.Tensor:
        out = got[i][used[i]:used[i] + count]
        used[i] += count
        return out

    def runs(f: int, end: int) -> int:
        """The runs of [f, end), one rank's each, in flat order."""
        while f < end:
            i = (f % row) // blk
            stop = min(end, f - (f % row) + (i + 1) * blk)
            parts.append(take(i, stop - f))
            f = stop
        return f

    lo, hi = rank * m, min((rank + 1) * m, n)
    f = runs(lo, min(hi, -(-lo // row) * row))  # up to a row's start
    rows = max(hi - f, 0) // row
    if rows:  # whole rows: each rank's runs side by side
        parts.append(torch.stack([take(i, rows * blk).view(rows, blk)
                                  for i in range(size)], 1).reshape(-1))
        f += rows * row
    runs(f, hi)
    piece = torch.cat(parts) if parts else x.new_empty((0,))
    piece = torch.nn.functional.pad(piece, (0, m - piece.numel()))
    return piece, whole


def _int8_zero3_gather(x: torch.Tensor, dim: Optional[int],
                       chunk: int = 256) -> torch.Tensor:
    """The whole leaf, int8-quantized per chunk, JAX's values
    (``repro.distributed.sharding._int8_zero3_gather`` on a mesh of the
    data axis): the leaf flattened, padded and cut into S contiguous
    pieces, each piece quantized per chunk, the int8 and the f32 scales
    gathered, dequantized in f32 and cast to the leaf's dtype. ``x`` is
    this rank's slice along ``dim`` (``_int8_pieces`` re-lays it out into
    its flat piece, since the port holds ``embed``-dim slices, not flat
    pieces: the full-precision leaf never crosses the wire whole), or, with
    ``dim`` None, the leaf held whole, quantized where it is: the chunks of
    JAX's pieces are the flattened leaf's, so the values are the same."""
    if dim is None:
        q, s = quantize_int8(x, chunk)
        return dequantize_int8(q, s, tuple(x.shape), chunk).to(x.dtype)
    piece, whole = _int8_pieces(x, dim, chunk)
    q, s = quantize_int8(piece, chunk)
    return dequantize_int8(compat.all_gather(q), compat.all_gather(s),
                           tuple(whole), chunk).to(x.dtype)


class _Int8Gather(torch.autograd.Function):
    """``_int8_zero3_gather``, whose backward is straight-through, with the
    cotangent rounded to bf16 as JAX's ``_grad_bf16`` rounds it.

    JAX rounds the GLOBAL cotangent once, bf16(c) with c = sum_r c_r, and
    reduce-scatters it (in f32). Here each rank holds its own rows' partial
    c_r, so a sliced leaf's cotangents are reduce-scattered in f32 first
    and the sum is rounded to bf16 after, then cast to the leaf's dtype:
    JAX's bf16(c) but for the order of the f32 sum, which can move a value
    that lies at a rounding boundary by one bf16 ulp. A leaf held whole
    has no collective here: its c_r passes through as it is, the train
    step's all-reduce sums it in f32, and the sum is not rounded (within
    2^-8 |c| of JAX's)."""

    @staticmethod
    def forward(ctx, x, dim, chunk):
        ctx.dim = dim
        return _int8_zero3_gather(x, dim, chunk)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is None:
            return g, None, None
        r = compat.reduce_scatter_along([g.to(torch.float32)], [ctx.dim])
        return r[0].to(torch.bfloat16).to(g.dtype), None, None


# ---------------------------------------------------------------------------
# the model axis: tensor-parallel regions and the residual stream's hook
# ---------------------------------------------------------------------------


def model_cut(path: tuple) -> bool:
    """Whether the active layout holds the param at ``path`` (a top-level
    or a stacked leaf) cut over a model axis of more than one rank."""
    _, _, layout = _current()
    return (layout is not None and layout.model_shards > 1
            and layout.model_dim_at(path) is not None)


def model_place() -> tuple[int, int]:
    """(this rank's index on the model axis, the axis's size) of the
    active layout; (0, 1) without one. The layout owns the model axis:
    where it cuts one, the registered mesh axis, which the region's
    collectives run over, must agree (``compat.expect``), else this
    raises."""
    _, _, layout = _current()
    if layout is None:
        return 0, 1
    if layout.model_shards > 1:
        compat.expect(compat.MODEL, layout.model_shards, layout.model_rank)
    return layout.model_rank, layout.model_shards


class _Enter(torch.autograd.Function):
    """Into a tensor-parallel region: the tensors as they are; the
    backward sums their grads over the model axis (one all-reduce a
    dtype)."""

    @staticmethod
    def forward(ctx, *xs):
        return xs if len(xs) > 1 else xs[0]

    @staticmethod
    def backward(ctx, *grads):
        return tuple(compat.all_reduce_buckets(list(grads), compat.MODEL))


class _Leave(torch.autograd.Function):
    """Out of a tensor-parallel region: the sum over the model axis of
    each rank's partial result; the backward passes the grad as it is."""

    @staticmethod
    def forward(ctx, x):
        return compat.all_reduce_sum(x, compat.MODEL)

    @staticmethod
    def backward(ctx, g):
        return g


def enter(*xs: torch.Tensor):
    """``xs`` into a tensor-parallel region (the rule in the module doc:
    once each, where a replicated tensor first meets cut compute). With
    autograd off, or the active layout's model axis of one, the tensors
    themselves."""
    if model_place()[1] == 1 or not torch.is_grad_enabled():
        return xs if len(xs) > 1 else xs[0]
    return _Enter.apply(*xs)


def leave(x: torch.Tensor) -> torch.Tensor:
    """A region's partial result summed over the model axis (the input
    itself on the active layout's model axis of one)."""
    if model_place()[1] == 1:
        return x
    return _Leave.apply(x)


def activation_constraint(x: torch.Tensor, kind: str) -> torch.Tensor:
    """JAX's annotation of an activation ("residual" [B,S,D], "batch"
    [B,...]): the batch is the rank's rows already, and the residual stream
    is whole on every model rank, so it is the identity, as JAX's is while
    ``seq_axis`` is None. Rules with a ``seq_axis`` (sequence parallelism,
    ROADMAP Queue 1 item 2, its sequence-parallel sub-item) raise."""
    mesh, rules, _ = _current()
    if mesh is None or rules is None or rules.seq_axis is None:
        return x
    raise NotImplementedError(
        f"activation_constraint({kind!r}) with seq_axis="
        f"{rules.seq_axis!r}: sequence parallelism is not ported (ROADMAP "
        "Queue 1 item 2, the sequence-parallel sub-item)")
