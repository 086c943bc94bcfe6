"""Parameter specs and their tensors.

The model declares its parameters as a nested dict of ``ParamSpec`` (shape,
logical axis names, initializer, scale), the layout of
``repro.models.params``: the layers of a stack share one tensor with a
leading layer dim (``blocks``, logical axis ``layers``). The logical axes
are what ``distributed.sharding`` maps onto the mesh (the JAX package's
vocabulary: "vocab", "embed", "heads", "kv_heads", "head_dim", "mlp",
"experts", "expert_mlp", "q_lora", "kv_lora", "ssm_inner", "ssm_heads",
"ssm_state", "conv", "layers", "blocks", None). From the spec tree come

* ``materialize`` — initialized tensors, drawn on the target device from a
  ``torch.Generator`` seeded per leaf from (seed, path);
* ``from_jax`` — the JAX package's parameters, or a whole JAX train state
  ``{"params", "opt": {"step", "m", "v"}, "step"}`` (numpy arrays in the
  same tree), carried over as tensors: how the tests compare the two
  packages, and how both take the same train step from one state. Any
  nesting carries over, the hybrid family's ``[groups, every, ...]`` SSM
  stacks and its unstacked ``shared_attn`` block included.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt | conv
    scale: float = 1.0  # stddev for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """Map ``fn(path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _path_seed(seed: int, path: tuple) -> int:
    key = f"{seed}/" + "/".join(map(str, path))
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "little") >> 1


def _uniform(spec: ParamSpec, g: torch.Generator, device, lo: float,
             hi: float) -> torch.Tensor:
    out = torch.empty(spec.shape, dtype=torch.float32, device=device)
    return out.uniform_(lo, hi, generator=g)


def materialize(
    specs: Any, seed: int, dtype: torch.dtype, device: torch.device | str
) -> Any:
    """Initialized parameters, drawn directly on ``device`` in ``dtype``.

    The SSM kinds follow ``repro.models.params``, drawn in f32 and cast:
    ``ssm_a`` is log U[1, 16] (so A = -exp(a_log) lies in [-16, -1]),
    ``ssm_dt`` the inverse softplus of a log-uniform dt in [1e-3, 0.1],
    ``conv`` U[-fan^-1/2, fan^-1/2] with fan the last dim."""

    def leaf(path, spec: ParamSpec) -> torch.Tensor:
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        if spec.init == "zeros":
            return out.zero_()
        if spec.init == "ones":
            return out.fill_(1.0)
        g = torch.Generator(device=device).manual_seed(_path_seed(seed, path))
        if spec.init == "ssm_a":
            return out.copy_(_uniform(spec, g, device, 1.0, 16.0).log_())
        if spec.init == "ssm_dt":
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = _uniform(spec, g, device, lo, hi).exp_()
            return out.copy_(torch.log(torch.expm1(dt)))
        if spec.init == "conv":
            bound = spec.shape[-1] ** -0.5
            return out.copy_(_uniform(spec, g, device, -bound, bound))
        if spec.init != "normal":
            raise ValueError(f"unknown init {spec.init!r} at {path}")
        return out.normal_(0.0, spec.scale, generator=g)

    return tree_map(leaf, specs)


def from_jax(
    tree: Any, device: torch.device | str, dtype: torch.dtype | None = None
) -> Any:
    """The JAX package's parameter tree or train state (numpy arrays, or
    anything ``np.asarray`` takes) as tensors on ``device``; ``dtype``
    recasts float leaves (int leaves such as the step counters keep
    theirs)."""

    def leaf(path, x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch conversion
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))  # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)
