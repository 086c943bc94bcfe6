"""Architecture registry of the port: ``get(name)`` / ``--arch <id>``.

Each module defines CONFIG (the full-scale configuration) and SMOKE (a
reduced same-family configuration for CPU tests), as in ``repro.configs``.
An architecture the port cannot run yet raises ``NotImplementedError``
naming its family.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# every architecture of the JAX package -> its family
ARCHS = {
    "llama3_8b": "dense",
    "granite_34b": "dense",
    "deepseek_7b": "dense",
    "qwen3_14b": "dense",
    "zamba2_2p7b": "hybrid",
    "musicgen_medium": "audio",
    "mamba2_370m": "ssm",
    "deepseek_v2_236b": "moe",
    "mixtral_8x22b": "moe",
    "pixtral_12b": "vlm",
}
PORTED = ("llama3_8b", "deepseek_7b", "qwen3_14b", "granite_34b",
          "mamba2_370m", "zamba2_2p7b")

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
    key = canonical(name)
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {key!r} ({ARCHS[key]} family) is not ported to PyTorch "
            f"yet; ported: {', '.join(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG.validate()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE.validate()
