"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Every assigned architecture is one module exposing ``config()`` (the exact
published shape) and ``smoke_config()`` (a reduced same-family variant for
CPU smoke tests).
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ArchConfig

ARCH_IDS: List[str] = [
    "deepseek_v3_671b",
    "dbrx_132b",
    "seamless_m4t_large_v2",
    "nemotron_4_15b",
    "gemma3_12b",
    "glm4_9b",
    "llama3_2_1b",
    "jamba_1_5_large_398b",
    "internvl2_26b",
    "rwkv6_7b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "deepseek-v3-671b": "deepseek_v3_671b",
    "dbrx-132b": "dbrx_132b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "nemotron-4-15b": "nemotron_4_15b",
    "gemma3-12b": "gemma3_12b",
    "glm4-9b": "glm4_9b",
    "llama3.2-1b": "llama3_2_1b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-26b": "internvl2_26b",
    "rwkv6-7b": "rwkv6_7b",
})


def _module(name: str):
    key = _ALIASES.get(name, name)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ArchConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()
