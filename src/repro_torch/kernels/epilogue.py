"""Fused GEMM epilogue: scale → bias → activation → round/clip.

The CUDA kernels apply it to the accumulator in registers before the
one store of the output; the plain versions apply this function to the
whole accumulator, in the same fixed order:

    acc                     f32 (float operands) or int32 (int8 operands)
    1. scale   y = acc * scale        f32, per-out-channel [N] or [1, N]
    2. bias    y = y + bias           f32 [N]
    3. act     y = act(y)             relu | gelu (tanh approx) | silu
    4. store   round (half to even) + clip to ±127 for an int8 output,
               plain cast otherwise (f32 → int32 truncates toward zero)

An int32 accumulator with no scale, no bias and act none or relu stays
exact in int32 (``max(acc, 0)``); any other step runs in f32, as the
reference's ``apply_epilogue``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["Epilogue", "apply_epilogue", "apply_act", "default_out_dtype",
           "ACTIVATIONS", "ACT_CODES"]

ACTIVATIONS = ("none", "relu", "gelu", "silu")
# integer codes the CUDA kernels take for ``act`` (csrc/common.cuh)
ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}

_INT8_MAX = 127.0


def _gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * y * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (y + 0.044715 * y ** 3)))


_ACT_FNS = {
    "relu": lambda y: torch.clamp_min(y, 0),
    "gelu": _gelu_tanh,
    "silu": lambda y: y * torch.sigmoid(y),
}


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """One of ACTIVATIONS by name, shared by the epilogue and the plain
    matmul route so fused and unfused routes cannot drift."""
    if act == "none":
        return y
    if act not in _ACT_FNS:
        raise ValueError(f"act={act!r} not in {ACTIVATIONS}")
    return _ACT_FNS[act](y)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Which epilogue steps run; the bias/scale tensors travel separately."""
    act: str = "none"
    has_bias: bool = False
    has_scale: bool = False

    def __post_init__(self):
        if self.act not in ACTIVATIONS:
            raise ValueError(f"act={self.act!r} not in {ACTIVATIONS}")


def apply_epilogue(acc: torch.Tensor, spec: Epilogue, out_dtype: torch.dtype,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulator ``[..., N]`` (f32, or int32 of int8 operands) → output
    of ``out_dtype``."""
    if spec.has_bias != (bias is not None):
        raise ValueError("bias presence disagrees with the epilogue spec")
    if spec.has_scale != (scale is not None):
        raise ValueError("scale presence disagrees with the epilogue spec")
    exact = (acc.dtype == torch.int32 and not spec.has_scale
             and not spec.has_bias and spec.act in ("none", "relu"))
    y = acc if exact else acc.float()
    if spec.has_scale:
        y = y * scale.float()
    if spec.has_bias:
        y = y + bias.float()
    y = apply_act(y, spec.act)
    if out_dtype == torch.int8:
        y = torch.clamp(torch.round(y.float()), -_INT8_MAX, _INT8_MAX)
    return y.to(out_dtype)


def default_out_dtype(operand_dtype: torch.dtype,
                      spec: Epilogue = Epilogue()) -> torch.dtype:
    """The output-dtype policy: int8 operands emit the raw int32
    accumulator unless a dequant scale is fused (then f32); float operands
    keep their dtype."""
    if operand_dtype == torch.int8:
        return torch.float32 if spec.has_scale else torch.int32
    return operand_dtype
