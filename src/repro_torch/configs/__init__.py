"""Architecture registry: arch id → `ModelConfig`.

Each module defines ``ARCH``, ``full()`` (the published widths) and
``smoke()`` (a reduced same-family config that runs on the CPU).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import ModelConfig, SHAPES, ShapeSpec, shape_applicable
from repro_torch.configs import (arctic_480b, convnet_dbb, kimi_k2_1t,
                                 lenet5_dbb, musicgen_medium, olmo_1b,
                                 paligemma_3b, qwen2_5_14b, rwkv6_1b6,
                                 starcoder2_15b, yi_34b, zamba2_1b2)

__all__ = ["ARCHS", "ASSIGNED", "get_config", "SHAPES", "ShapeSpec",
           "shape_applicable"]

ARCHS: Dict[str, object] = {m.ARCH: m for m in (
    olmo_1b, qwen2_5_14b, yi_34b, starcoder2_15b, arctic_480b, kimi_k2_1t,
    zamba2_1b2, rwkv6_1b6, paligemma_3b, musicgen_medium, convnet_dbb,
    lenet5_dbb)}

# The ten assigned LM-family architectures (the dry run's 40 cells); the CNN
# configs are the paper's own models.
ASSIGNED: List[str] = [
    "qwen2.5-14b", "olmo-1b", "yi-34b", "starcoder2-15b", "musicgen-medium",
    "rwkv6-1.6b", "zamba2-1.2b", "paligemma-3b", "arctic-480b",
    "kimi-k2-1t-a32b",
]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = ARCHS[arch]
    return mod.smoke() if smoke else mod.full()
