"""Architecture config registry: ``get_config("<arch-id>")`` and
``get_smoke_config("<arch-id>")`` for every assigned architecture (the
reference's ``repro.configs``, the same ten files)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..core.config import ArchConfig

_MODULES = {
    "command-r-35b": "command_r_35b",
    "deepseek-67b": "deepseek_67b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-medium": "whisper_medium",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _mod(name).SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
