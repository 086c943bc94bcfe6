"""Architecture registry of the port: ``get(name)`` / ``--arch <id>``.

Each module defines CONFIG (the full-scale configuration) and SMOKE (a
reduced same-family configuration for CPU tests), as in ``repro.configs``:
every architecture of the JAX package, field for field.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "llama3_8b",
    "granite_34b",
    "deepseek_7b",
    "qwen3_14b",
    "zamba2_2p7b",
    "musicgen_medium",
    "mamba2_370m",
    "deepseek_v2_236b",
    "mixtral_8x22b",
    "pixtral_12b",
)

_ALIASES = {name.replace("_", "-"): name for name in ARCHS}
_ALIASES.update({"zamba2-2.7b": "zamba2_2p7b"})


def canonical(name: str) -> str:
    key = name.strip().lower()
    if key in ARCHS:
        return key
    if key in _ALIASES:
        return _ALIASES[key]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get(name: str, smoke: bool = False, layers: int = 0) -> ModelConfig:
    """The arch's full-scale config (``smoke``: its reduced one), its depth
    cut to ``layers`` where given, the widths kept."""
    mod = _module(name)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg.validate()


def get_smoke(name: str) -> ModelConfig:
    return get(name, smoke=True)
