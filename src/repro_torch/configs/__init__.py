"""Architecture registry of the port: ``get(name)`` / ``--arch <id>``.

Each module defines CONFIG (the full-scale configuration) and SMOKE (a
reduced same-family configuration for CPU tests), as in ``repro.configs``.
An architecture the port cannot run yet raises ``NotImplementedError``
naming its family, or what it still lacks where its family is ported.
"""

from __future__ import annotations

import dataclasses
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
          "mamba2_370m", "zamba2_2p7b", "mixtral_8x22b")
# unported archs of a ported family -> what they still lack
MISSING = {"deepseek_v2_236b": "MLA attention (multi-head latent "
                               "attention), which is not ported yet"}

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
    if key in MISSING:
        raise NotImplementedError(
            f"arch {key!r} ({ARCHS[key]} family) needs {MISSING[key]}")
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {key!r} ({ARCHS[key]} family) is not ported to PyTorch "
            f"yet; ported: {', '.join(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{key}")


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
