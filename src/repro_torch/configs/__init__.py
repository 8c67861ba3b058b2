"""Architecture registry: exact assigned configs + reduced smoke configs.

``get(name)`` returns the full config; ``get_smoke(name)`` a reduced config
of the same family for CPU smoke tests. ``--arch <id>`` in the launchers
resolves through this registry.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "smollm-135m",
    "yi-9b",
    "llama3-405b",
    "granite-34b",
    "mamba2-130m",
    "zamba2-7b",
    "internvl2-1b",
    "qwen3-moe-30b-a3b",
    "granite-moe-3b-a800m",
    "seamless-m4t-large-v2",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE

