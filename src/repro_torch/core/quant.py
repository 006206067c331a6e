"""INT8 symmetric quantization (the paper's INT8 operands, INT32 sums).

  * weights: symmetric per-output-channel scales, int8 storage — what
    ``pack_tree(quantize=True)`` stores as a DBB values plane
  * activations: a symmetric per-tensor scale
  * ``int8_matmul``: the plain int8 × int8 → int32 product, exact (the
    sums are taken in f64, which holds every int32 sum of these terms)
  * ``fake_quant``: quantize-dequantize with a straight-through gradient
    (quantization-aware training)

The arithmetic is the JAX package's (f32 scales, round half to even,
clip to ±127), so quantized planes are byte-equal across the two.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["QuantizedWeight", "quantize_weight", "dequantize_weight",
           "fake_quant", "act_scale", "int8_matmul", "quant_error"]

_INT8_MAX = 127.0


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    q: torch.Tensor        # int8 [K, N]
    scale: torch.Tensor    # f32 [N] per-out-channel


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-out-channel INT8 quantization of ``W[K, N]``."""
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / _INT8_MAX,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale[None, :]), -_INT8_MAX, _INT8_MAX)
    return QuantizedWeight(q=q.to(torch.int8), scale=scale)


def dequantize_weight(qw: QuantizedWeight,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (qw.q.to(torch.float32) * qw.scale[None, :]).to(dtype)


class _FakeQuant(torch.autograd.Function):
    """Forward: quantize-dequantize. Backward: the upstream gradient."""

    @staticmethod
    def forward(ctx, w):
        return dequantize_weight(quantize_weight(w), w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(w: torch.Tensor) -> torch.Tensor:
    """``W[K, N]`` through the INT8 grid (per-out-channel scales) and back
    in its own dtype, with a straight-through gradient (QAT)."""
    return _FakeQuant.apply(w)


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric activation scale (f32 scalar tensor)."""
    amax = x.abs().amax().to(torch.float32)
    return torch.where(amax > 0, amax / _INT8_MAX, torch.ones_like(amax))


def int8_matmul(x: torch.Tensor, qw: QuantizedWeight,
                x_scale: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ W`` on the INT8 datapath: int8 operands, exact integer sums.

    x: float ``[..., K]`` (quantized on the fly unless already int8).
    Returns ``(x_q @ w_q) * x_scale * w_scale`` in ``out_dtype``."""
    if x.dtype == torch.int8:
        xq = x
        xs = (x_scale if x_scale is not None
              else torch.tensor(1.0, device=x.device))
    else:
        xs = act_scale(x) if x_scale is None else x_scale
        xq = torch.clamp(torch.round(x / xs), -_INT8_MAX,
                         _INT8_MAX).to(torch.int8)
    acc = (xq.to(torch.float64) @ qw.q.to(torch.float64)).to(torch.int32)
    return (acc.to(torch.float32) * xs * qw.scale).to(out_dtype)


def quant_error(w: torch.Tensor) -> torch.Tensor:
    """RMS relative quantization error (diagnostics)."""
    wq = dequantize_weight(quantize_weight(w))
    denom = torch.sqrt(torch.mean(w.to(torch.float32) ** 2)) + 1e-12
    return torch.sqrt(torch.mean((w - wq) ** 2)) / denom
