"""Assigned-architecture registry: --arch <id> resolves here.

A copy of the JAX package's ``configs/``: the ten published
architectures, each ``CONFIG`` and its ``REDUCED`` test size.  The port's
model runs all six families: ``dense``, ``moe``, ``vlm``, ``ssm``,
``hybrid`` and ``audio``.
"""
from importlib import import_module

ARCHS = [
    "deepseek-coder-33b",
    "minitron-4b",
    "qwen2-1.5b",
    "minitron-8b",
    "rwkv6-3b",
    "whisper-medium",
    "zamba2-2.7b",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "qwen2-vl-7b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str, reduced: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
