"""Config registry: ``get(name)`` resolves an ArchConfig by id."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "xlstm-350m",
    "zamba2-7b",
    "qwen3-32b",
    "mistral-nemo-12b",
    "glm4-9b",
    "whisper-large-v3",
    "internlm2-1.8b",
    "phi3.5-moe-42b-a6.6b",
    "qwen2-vl-2b",
    "qwen2-moe-a2.7b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get(a) for a in ARCH_IDS}
