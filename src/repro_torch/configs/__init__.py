"""Architecture config registry: ``get_config(id)`` / ``get_smoke_config``
(counterpart of ``repro.configs``).

Each <arch>.py holds the full config (CONFIG) and a reduced same-family
smoke variant (SMOKE) for CPU tests, with the reference's shapes and
sources.
"""
from __future__ import annotations

import importlib

from .shapes import SHAPES, shapes_for

_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "yi-6b": "yi_6b",
    "llama3-405b": "llama3_405b",
    "starcoder2-15b": "starcoder2_15b",
    "minicpm-2b": "minicpm_2b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "mamba2-780m": "mamba2_780m",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-2.7b": "zamba2_2p7b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE


__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_smoke_config",
           "shapes_for"]
