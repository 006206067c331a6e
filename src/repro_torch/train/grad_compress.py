"""Gradient compression with error feedback.

The numerics of the round trip a worker's gradient makes through a
compressed all-reduce: "none", "bf16" (a bf16 round trip), or "int8_ef"
(per-tensor symmetric INT8 with an error-feedback accumulator, EF-SGD,
which carries each step's rounding error into the next). On one device
there is no reduction: the round trip is what the optimizer sees.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.train.tree import tree_map, tree_unzip

__all__ = ["init_ef_state", "compress_grads", "wire_bytes_per_elem"]


def wire_bytes_per_elem(mode: str) -> float:
    return {"none": 4.0, "bf16": 2.0, "int8_ef": 1.0}[mode]


def init_ef_state(params: Any, mode: str) -> Optional[Any]:
    """Zeros like the params (f32) for "int8_ef", else None."""
    if mode != "int8_ef":
        return None
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _q_int8(g: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor INT8 quantize → dequantize."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(g32 / scale), -127, 127) * scale


def compress_grads(grads: Any, ef: Optional[Any], mode: str
                   ) -> Tuple[Any, Optional[Any]]:
    """(the gradients after the round trip, the new error-feedback
    state)."""
    if mode == "none":
        return grads, ef
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads), ef
    if mode == "int8_ef":
        def one(g, e):
            target = g.float() + e
            sent = _q_int8(target)
            return sent, target - sent
        sent, new_ef = tree_unzip(tree_map(one, grads, ef), 2)
        return sent, new_ef
    raise ValueError(mode)
