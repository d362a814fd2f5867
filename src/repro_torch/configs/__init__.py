"""Architecture registry: ``--arch <id>`` -> ModelConfig.

``get_config(name)`` returns the FULL config (dry-run only — never allocate).
``get_smoke(name)`` returns the reduced variant for CPU smoke tests.
``long_500k_policy(name)`` in {"run", "swa", "skip"} — see DESIGN.md §4.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen3-14b": "qwen3_14b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-780m": "mamba2_780m",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "internlm2-20b": "internlm2_20b",
    "minitron-4b": "minitron_4b",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke()


def long_500k_policy(name: str) -> str:
    return getattr(_mod(name), "LONG_500K_POLICY", "skip")
