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
with a ``shape`` dict (``launch.mesh.Mesh.shape`` is ``{"data": S,
"model": 1}``), as the JAX ``spec_for`` reads only ``mesh.shape``.

What the port places with these tables: the ZeRO-1 optimizer moments over
the data axis (``distributed.zero``). The parameters themselves stay
replicated on every rank (ROADMAP Queue 1 item 2: FSDP placement comes
with the model axis).

Not ported (they belong with the model axis): the JAX module's activation
and parameter constraint hooks, lines 181-376 (``set_rules``,
``use_rules``, ``param_gather_constraint``, ``_int8_zero3_gather``,
``ulysses_constraint``, ``cp_kv_gather``, ``activation_constraint``), and
the ``AxisRules`` fields only they read (``seq_axis``, ``model_axis``,
``gather_params``, ``int8_gather``, ``ulysses``): ``AxisRules`` here holds
the rule table and the batch axes, all that the placement tables read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from repro_torch.models.params import ParamSpec, tree_map

MeshAxes = Optional[Union[tuple[str, ...], str]]
PartitionSpec = tuple  # one MeshAxes entry per dim


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis -> mesh axis (or tuple of axes) mapping."""

    rules: dict[Optional[str], MeshAxes]
    batch_axes: tuple[str, ...] = ("data",)

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
