"""Architecture configs ported so far (the JAX package's registry, cut down).

Each module exposes ``CONFIG`` (full size) and ``smoke()`` (reduced same-
family config for CPU tests).  ``get(name)`` / ``ARCHS`` are the registry.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen2_0_5b",
    "mixtral_8x7b",
]

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "qwen2-0.5b": "qwen2_0_5b",
    "mixtral-8x7b": "mixtral_8x7b",
})


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"unknown or not yet ported architecture {name!r}; "
                       f"ported: {sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __package__)


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke()
