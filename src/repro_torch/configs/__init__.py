"""Architecture registry: arch id → `ModelConfig`.

Each module defines ``ARCH``, ``full()`` (the published widths) and
``smoke()`` (a reduced same-family config that runs on the CPU).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import ModelConfig
from repro_torch.configs import (arctic_480b, convnet_dbb, kimi_k2_1t,
                                 lenet5_dbb, musicgen_medium, olmo_1b,
                                 paligemma_3b, qwen2_5_14b, rwkv6_1b6,
                                 starcoder2_15b, yi_34b, zamba2_1b2)

__all__ = ["ARCHS", "get_config"]

ARCHS: Dict[str, object] = {m.ARCH: m for m in (
    olmo_1b, qwen2_5_14b, yi_34b, starcoder2_15b, arctic_480b, kimi_k2_1t,
    zamba2_1b2, rwkv6_1b6, paligemma_3b, musicgen_medium, convnet_dbb,
    lenet5_dbb)}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = ARCHS[arch]
    return mod.smoke() if smoke else mod.full()
