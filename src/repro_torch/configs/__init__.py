"""Architecture configs: the JAX package's registry.

Each module exposes ``CONFIG`` (full size) and ``smoke()`` (reduced same-
family config for CPU tests).  ``get(name)`` / ``ARCHS`` are the registry.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "recurrentgemma_2b",
    "smollm_135m",
    "llama3_2_1b",
    "qwen2_0_5b",
    "gemma3_1b",
    "llama3_2_vision_11b",
    "musicgen_large",
    "rwkv6_1_6b",
    "deepseek_v3_671b",
    "mixtral_8x7b",
]

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "recurrentgemma-2b": "recurrentgemma_2b",
    "smollm-135m": "smollm_135m",
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma3-1b": "gemma3_1b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "musicgen-large": "musicgen_large",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mixtral-8x7b": "mixtral_8x7b",
})


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __package__)


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke()
