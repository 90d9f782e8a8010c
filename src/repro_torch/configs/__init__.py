"""Architecture configs of the port: one module per ported arch + registry.

``get_config(arch_id)`` returns the full published config and
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests,
as ``repro.configs`` does.  ``ARCHS`` lists every arch of the reference,
and each has a module here (``PORTED``).
"""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "PORTED", "get_config", "get_smoke_config"]

ARCHS = [
    "gemma-2b", "deepseek-7b", "granite-3-2b", "gemma2-9b", "xlstm-125m",
    "hubert-xlarge", "deepseek-v3-671b", "mixtral-8x22b", "zamba2-7b",
    "qwen2-vl-2b",
]
PORTED = list(ARCHS)


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke()
