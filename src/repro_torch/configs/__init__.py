"""Architecture registry: 10 assigned archs (+ smoke variants).

Counterpart of ``repro.configs``: the same ten architectures, each
module's ``CONFIG`` (published widths) and ``SMOKE`` (a few layers,
narrow widths), the same shape grid and sharding-rule derivation."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ShapeSpec,
                                      applicable_shapes, arch_rules,
                                      skip_reason)

_MODULES = {
    "yi-6b": "yi_6b",
    "qwen3-14b": "qwen3_14b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "starcoder2-7b": "starcoder2_7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-780m": "mamba2_780m",
    "hubert-xlarge": "hubert_xlarge",
    "paligemma-3b": "paligemma_3b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["SHAPES", "ShapeSpec", "applicable_shapes", "arch_rules",
           "skip_reason", "ARCH_NAMES", "get_config"]
