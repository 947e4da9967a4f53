"""Assigned-architecture registry: ``get_config("<arch-id>")``.

One module per architecture with the exact published dimensions
(``[source; verified-tier]`` noted per file).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig, SHAPES, InputShape, shape_applicable

ARCH_IDS = [
    "phi_3_vision_4_2b",
    "starcoder2_3b",
    "qwen3_0_6b",
    "qwen3_4b",
    "yi_6b",
    "whisper_small",
    "zamba2_1_2b",
    "mamba2_130m",
    "granite_moe_1b_a400m",
    "grok_1_314b",
]

_ALIAS = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-4b": "qwen3_4b",
    "yi-6b": "yi_6b",
    "whisper-small": "whisper_small",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-130m": "mamba2_130m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "grok-1-314b": "grok_1_314b",
}


def canonical(arch: str) -> str:
    return _ALIAS.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(arch)}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "get_config", "all_configs", "canonical",
           "ModelConfig", "SHAPES", "InputShape", "shape_applicable"]
